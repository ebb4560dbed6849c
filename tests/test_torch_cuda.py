"""Tests of the PyTorch port that need a CUDA device: the hand-written
ragged paged-attention kernel (float pools and int8/fp8 pools with page
scales on the split-KV design where ``split_kv`` admits them, the first
design elsewhere), the flash-attention
forward, dq and dk/dv kernels, the fused-CE forward, dh and dw kernels,
the shared-dl dh/dw pair and the packed (segment-id) flash forward, dq
and dk/dv kernels against their plain PyTorch versions (the bf16 flash
forward, dq, dk/dv, recomputing dh and dw, dh_sharep, dw_sharep and
packed forward, dq and dk/dv on their wgmma/TMA designs, float32 on the
others), the serving
engine on the card against
the same engine on the CPU (float and quantized pools, int8 weights), the
captured engine (CUDA graphs of the serving programs) against the eager
one, per phase and with ``mixed_step=True``, serving resilience on it
(preempt-and-resume over bf16, int8 and fp8 pools against the eager
engine, no capture after the constructor through every drill, the pages
no live slot holds kept across the replay after an abort, ``close()``),
speculative decoding on it (captured against eager over bf16, int8 and
fp8 pools and with int8 weights, per phase and mixed; no capture after
the constructor; the verify replay's traced kernels against its capture
record), and
GPT and packed-BERT training steps through the kernels against the same
steps through the plain versions, and the ResNet slice (conv, batch norm
and pooling on cuDNN/ATen, a ResNet-18 ``multi_step`` with Momentum) on
the card against the CPU.

Every test skips without a card (the kernels have no CPU mode). This file
imports no JAX, so it also runs on the GPU machine, which has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py imports JAX for the reference's
tests)."""
import contextlib
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models.gpt import gpt2_tiny, init_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, seed, NP=17, PS=8, NH=4, HD=16, MP=4, QB=8):
    """Decode row, full prefill row, k+1 row, idle slot (the reference's
    tests/test_ragged_kernel.py ``_mixed_case`` layout)."""
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(4, QB, NH, HD), dtype=torch.float32)
    k = torch.tensor(rng.randn(NP, PS, NH, HD), dtype=torch.float32)
    v = torch.tensor(rng.randn(NP, PS, NH, HD), dtype=torch.float32)
    bt = torch.tensor(rng.permutation(np.arange(1, NP))[:4 * MP]
                      .reshape(4, MP), dtype=torch.int32)
    kl = torch.tensor([min(27, MP * PS), QB, 12, 0], dtype=torch.int32)
    ql = torch.tensor([1, QB, 4, 1], dtype=torch.int32)
    return [t.to(dev) for t in (q, k, v, bt, kl, ql)]


def _live_err(out, ref, ql):
    live = (torch.arange(out.shape[1], device=out.device)[None]
            < ql[:, None])[:, :, None, None]
    return float(((out.float() - ref.float()).abs() * live).max())


@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2),
    (torch.float32, torch.bfloat16, 1e-4),
])
def test_kernel_matches_plain(cuda, q_dtype, kv_dtype, tol):
    q, k, v, bt, kl, ql = _case(cuda, 9)
    q, k, v = q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)
    before = pa.launches
    out = pa.ragged_paged_attention(q, k, v, bt, kl, ql)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert out.dtype == q_dtype
    ref = pa.ragged_paged_attention_ref(q, k, v, bt, kl, ql)
    assert _live_err(out, ref, ql) <= tol
    assert torch.all(out[3] == 0)
    assert torch.isfinite(out).all()


def test_kernel_head_dim_128_uses_large_shared_memory(cuda):
    """HD=128 needs more than 48 KB of shared memory a block, which the
    launch must opt into."""
    q, k, v, bt, kl, ql = _case(cuda, 10, NP=9, PS=16, NH=2, HD=128, MP=2,
                                QB=20)
    out = pa.ragged_paged_attention(q, k, v, bt, kl, ql)
    torch.cuda.synchronize()
    ref = pa.ragged_paged_attention_ref(q, k, v, bt, kl, ql)
    assert _live_err(out, ref, ql) <= 1e-4


def test_wrapper_raises_on_mixed_devices(cuda):
    q, k, v, bt, kl, ql = _case(cuda, 11)
    with pytest.raises(ValueError):
        pa.ragged_paged_attention(q, k, v, bt, kl.cpu(), ql)


def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    cfg = gpt2_tiny()
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(12)
    reqs = [(rng.randint(0, 128, int(n)), int(m))
            for n, m in ((5, 30), (19, 12), (40, 25), (11, 40))]
    outs = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params, device=dev, num_slots=3,
                            page_size=8, prefill_chunk=8, max_seq_len=128)
        pa.reset_launches()
        uids = [eng.add_request(p, n) for p, n in reqs]
        done = eng.run(max_steps=2000)
        outs[str(dev)] = [done[u].tokens for u in uids]
        forwards = eng.stats["prefill_chunks"] + eng.stats["decode_steps"]
        assert pa.launches == (0 if dev == "cpu"
                               else cfg.num_layers * forwards)
        assert eng.stats["fused_blocks"] > 0
        eng.kv.verify()
    assert outs["cpu"] == outs[str(cuda)]


# -- the quantized ragged kernel (int8 / fp8 pools with page scales) ---------

def _quant_case(dev, seed, fmt, q_dtype, HD, NH=4, PS=8, NP=17, MP=4,
                QB=8, unaligned=False):
    """The mixed case over pools quantized by the port's
    ``quantize_per_page``, pages and heads of very different magnitude
    (so a wrong scale index shows). ``unaligned`` offsets the pools by
    one byte, off the kernel's 4-byte word loads."""
    from paddle_tpu_torch.quantization.kv import quantize_per_page
    q, k, v, bt, kl, ql = _case("cpu", seed, NP=NP, PS=PS, NH=NH, HD=HD,
                                MP=MP, QB=QB)
    rng = np.random.RandomState(seed + 100)
    mag = torch.tensor(10.0 ** rng.uniform(-3, 2, (NP, 1, NH, 1)),
                       dtype=torch.float32)
    kq, ks = quantize_per_page((k * mag).to(dev), dtype=fmt)
    vq, vs = quantize_per_page((v * mag.flip(0)).to(dev), dtype=fmt)
    if unaligned:
        def shift(t):
            raw = torch.empty(t.numel() + 1, dtype=torch.uint8, device=dev)
            out = raw[1:].view(t.dtype).view(t.shape)
            out.copy_(t)
            return out
        kq, vq = shift(kq), shift(vq)
    return [t.to(dev) for t in (q.to(q_dtype), bt, kl, ql)], kq, vq, ks, vs


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("q_dtype,tol", [(torch.float32, 1e-4),
                                         (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("HD,unaligned", [(64, False), (128, False),
                                          (18, False), (64, True)],
                         ids=["hd64", "hd128", "hd18_bytes",
                              "hd64_unaligned"])
def test_quant_kernel_matches_plain(cuda, fmt, q_dtype, tol, HD, unaligned):
    (q, bt, kl, ql), kq, vq, ks, vs = _quant_case(
        cuda, 21, fmt, q_dtype, HD, unaligned=unaligned)
    pa.reset_launches()
    out = pa.ragged_paged_attention(q, kq, vq, bt, kl, ql, k_scale=ks,
                                    v_scale=vs)
    torch.cuda.synchronize()
    assert (pa.launches, pa.quant_launches) == (0, 1)
    # int8 and fp8 at HD 64 and 128 aligned: the split-KV design; HD 18 or
    # unaligned: the first design
    assert pa.quant_split_launches == int(HD % 16 == 0 and not unaligned)
    assert out.dtype == q_dtype
    ref = pa.ragged_paged_attention_ref(q, kq, vq, bt, kl, ql, k_scale=ks,
                                        v_scale=vs)
    # max-abs error over max-abs plain on the live rows
    assert _live_err(out, ref, ql) <= tol * float(ref.float().abs().max())
    assert torch.all(out[3] == 0)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("bad", ["scales_on_float_pool", "no_scales",
                                 "one_scale", "scale_shape", "scale_f16",
                                 "scale_on_cpu"])
def test_quant_wrapper_rejects_bad_scales(cuda, bad):
    (q, bt, kl, ql), kq, vq, ks, vs = _quant_case(cuda, 22, "int8",
                                                  torch.float32, 16)
    if bad == "scales_on_float_pool":
        kq, vq = kq.float(), vq.float()
    elif bad == "no_scales":
        ks = vs = None
    elif bad == "one_scale":
        vs = None
    elif bad == "scale_shape":
        ks, vs = ks[1:].contiguous(), vs[1:].contiguous()
    elif bad == "scale_f16":
        ks, vs = ks.half(), vs.half()
    elif bad == "scale_on_cpu":
        ks, vs = ks.cpu(), vs.cpu()
    pa.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        pa.ragged_paged_attention(q, kq, vq, bt, kl, ql, k_scale=ks,
                                  v_scale=vs)
    assert pa.quant_launches == 0 and pa.launches == 0


def test_quant_wrapper_raises_on_cuda_without_the_library(cuda, tmp_path,
                                                          monkeypatch):
    """No fallback: with the library unbuildable a CUDA q over a
    quantized pool raises."""
    import torch.utils.cpp_extension as ext
    from paddle_tpu_torch.kernels import _build
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(pa, "_fns", {})
    (q, bt, kl, ql), kq, vq, ks, vs = _quant_case(cuda, 23, "fp8",
                                                  torch.float32, 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        pa.ragged_paged_attention(q, kq, vq, bt, kl, ql, k_scale=ks,
                                  v_scale=vs)


@pytest.mark.parametrize("kv_dtype,weight_dtype", [("int8", None),
                                                   ("fp8", "int8")])
def test_quantized_engine_on_the_card_matches_the_cpu_engine(
        cuda, kv_dtype, weight_dtype):
    cfg = gpt2_tiny()
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(24)
    reqs = [(rng.randint(0, 128, int(n)), int(m))
            for n, m in ((5, 30), (19, 12), (40, 25), (11, 40))]
    outs = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params, device=dev, num_slots=3,
                            page_size=8, prefill_chunk=8, max_seq_len=128,
                            kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        pa.reset_launches()
        uids = [eng.add_request(p, n) for p, n in reqs]
        done = eng.run(max_steps=2000)
        outs[str(dev)] = [done[u].tokens for u in uids]
        forwards = eng.stats["prefill_chunks"] + eng.stats["decode_steps"]
        assert pa.launches == 0
        assert pa.quant_launches == (0 if dev == "cpu"
                                     else cfg.num_layers * forwards)
        assert eng.kv.k[0].dtype == {"int8": torch.int8,
                                     "fp8": torch.float8_e4m3fn}[kv_dtype]
        eng.kv.verify()
    assert outs["cpu"] == outs[str(cuda)]


# -- the captured engine (CUDA graphs of the serving programs) ---------------

COUNTS = ("launches", "split_launches", "quant_launches",
          "quant_split_launches")


def _graph_reqs():
    """Greedy and sampled requests, a shared prefix and a prompt of whole
    pages served twice (copy-on-write)."""
    rng = np.random.RandomState(31)
    shared = rng.randint(0, 128, 16)
    reqs = [(rng.randint(0, 128, int(n)), int(m), t, 40 + i)
            for i, (n, m, t) in enumerate(((5, 30, 0.0), (19, 12, 0.9),
                                           (40, 25, 0.0), (11, 40, 0.7)))]
    reqs += [(shared, 9, 0.0, 0),
             (np.concatenate([shared, rng.randint(0, 128, 7)]), 20, 0.8, 3),
             (shared.copy(), 14, 0.0, 0)]
    return reqs


def _graph_engine(dev, capture, **kw):
    cfg = gpt2_tiny()
    return ServingEngine(cfg, init_params(cfg, seed=1, device="cpu"),
                         device=dev, num_slots=3, page_size=8,
                         prefill_chunk=8, max_seq_len=128,
                         record_logits=True, _capture=capture, **kw)


def _graph_serve(eng, reqs):
    """Serve ``reqs``, draining after the fifth (the shared prompt's
    pages turn cached); returns each request's tokens."""
    uids, done = [], {}
    for i, (p, n, t, seed) in enumerate(reqs):
        uids.append(eng.add_request(p, n, temperature=t, seed=seed))
        if i == 4:
            done.update(eng.run(max_steps=2000))
    done.update(eng.run(max_steps=2000))
    eng.kv.verify()
    return [done[u].tokens for u in uids]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_captured_engine_equals_the_eager_engine_bit_for_bit(cuda, kv_dtype,
                                                             mixed):
    """The same kernels in the same order: tokens, every logged logit and
    every launch counter as the eager engine's."""
    runs = []
    for capture in (True, False):
        eng = _graph_engine(cuda, capture, kv_dtype=kv_dtype,
                            mixed_step=mixed)
        pa.reset_launches()
        toks = _graph_serve(eng, _graph_reqs())
        torch.cuda.synchronize()
        runs.append((toks, [eng.logit_log[u] for u in sorted(eng.logit_log)],
                     [getattr(pa, c) for c in COUNTS], dict(eng.stats)))
    (tc, lc, cc, sc), (te, le, ce, se) = runs
    assert tc == te
    for a, b in zip(lc, le):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cc == ce and sum(cc) > 0
    layers = gpt2_tiny().num_layers
    forwards = (sc["mixed_steps"] if mixed
                else sc["prefill_chunks"] + sc["decode_steps"])
    assert cc[0 if kv_dtype is None else 2] == layers * forwards
    assert sc["graph_replays"] == sc["dispatches"] + sc["cow_copies"]
    assert se["graph_captures"] == se["graph_replays"] == 0
    for key in sc:
        if not key.startswith("graph_"):
            assert sc[key] == se[key], key


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_graph_captures_are_fixed_after_construction(cuda, mixed):
    eng = _graph_engine(cuda, True, mixed_step=mixed)
    # per phase: the decode step, blocks of 4, 8 and 16, the prefill chunk
    # and the page copy; mixed: the mixed program and the page copy
    n = eng.stats["graph_captures"]
    assert n == (2 if mixed else 6)
    assert eng.capture_seconds > 0
    first = _graph_serve(eng, _graph_reqs())
    replays = eng.stats["graph_replays"]
    second = _graph_serve(eng, _graph_reqs())
    assert eng.stats["graph_captures"] == n
    assert eng.stats["graph_replays"] > replays > 0
    assert first == second
    assert eng.stats["cow_copies"] > 0 and eng.stats["prefix_hits"] > 0


@pytest.mark.parametrize("kv_dtype,mixed", [(None, False), ("int8", False),
                                            ("fp8", False), ("int8", True)])
def test_capture_writes_only_the_trash_page(cuda, kv_dtype, mixed):
    """Warm-up and capture run on the idle state: every page but the
    trash page 0 keeps its bytes, scales too, and the allocator
    verifies."""
    eng = _graph_engine(cuda, False, kv_dtype=kv_dtype, mixed_step=mixed)
    kv = eng.kv
    g = torch.Generator(device=cuda).manual_seed(5)
    tensors = (*kv.k, *kv.v, *kv.k_scale, *kv.v_scale)
    for t in tensors:
        b = pa.byte_view(t) if t.element_size() == 1 else t
        if b.dtype == torch.float32:
            b.copy_(torch.rand(b.shape, generator=g, device=cuda))
        else:
            b.copy_(torch.randint(-100, 100, b.shape, generator=g,
                                  device=cuda).to(b.dtype))
    before = [pa.byte_view(t).clone() for t in tensors]
    eng._progs = eng._build_programs(True)
    torch.cuda.synchronize()
    assert eng.stats["graph_captures"] == (2 if mixed else 6)
    changed0 = False
    for t, b in zip(tensors, before):
        now = pa.byte_view(t)
        assert torch.equal(now[1:], b[1:])
        changed0 |= not torch.equal(now[0], b[0])
    assert changed0
    kv.verify()
    assert kv.num_free == kv.num_pages - 1
    # and the engine serves from there
    assert all(_graph_serve(eng, _graph_reqs()[:4]))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_each_graph_records_its_kernel_launches(cuda, kv_dtype):
    """A graph's counter deltas are its program's launches: one a layer
    and forward pass, on the counters of its pool kind."""
    L = gpt2_tiny().num_layers
    for mixed in (False, True):
        pa.reset_launches()
        eng = _graph_engine(cuda, True, kv_dtype=kv_dtype, mixed_step=mixed)
        per = {"copy_page": 0, "prefill": L, "mixed": L,
               **{k: L * k for k in eng.decode_block_buckets}}
        for key, prog in eng._progs.items():
            want = [per[key]] * 2 + [0, 0]
            if kv_dtype:
                want = want[2:] + want[:2]
            assert prog.deltas == want, key
        # the warm-up launched; the capture did not
        warm = sum(getattr(pa, c) for c in COUNTS)
        assert warm == 2 * 2 * sum(per[k] for k in eng._progs)


def test_a_capture_that_fails_raises(cuda):
    """No eager fallback: a program that cannot be captured (here a host
    read inside the ragged kernel's wrapper) fails the constructor. In a
    process of its own: a failed capture may leave the allocator's state
    behind."""
    code = (
        "import torch\n"
        "from paddle_tpu_torch.inference.serving import ServingEngine\n"
        "from paddle_tpu_torch.kernels import paged_attention as pa\n"
        "from paddle_tpu_torch.models.gpt import gpt2_tiny\n"
        "real = pa._launch\n"
        "def reads_the_host(q, *args):\n"
        "    out = real(q, *args)\n"
        "    float(out.float().sum())\n"
        "    return out\n"
        "pa._launch = reads_the_host\n"
        "try:\n"
        "    ServingEngine(gpt2_tiny(), device='cuda', num_slots=2,\n"
        "                  page_size=8, prefill_chunk=8, max_seq_len=64)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n"
        "    raise SystemExit(3)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 3, res.stdout + res.stderr
    assert "raised:" in res.stdout


# -- serving resilience on the captured engine ---------------------------------

def _low_reqs():
    """Three requests that fill the three slots of a pool short of pages,
    the last admitted sampled, and a long arrival of priority 5 that must
    preempt it."""
    rng = np.random.RandomState(41)
    lows = [dict(prompt=rng.randint(0, 128, n), max_new_tokens=40,
                 temperature=t, seed=60 + i)
            for i, (n, t) in enumerate(((22, 0.0), (30, 0.0), (27, 0.8)))]
    high = dict(prompt=rng.randint(0, 128, 60), max_new_tokens=20,
                priority=5)
    return lows, high


RES_POOL = 1 + 3 * 9 + 2     # the three requests' pages and 2 more


def _decoding(eng, uid, n=1):
    s = next((s for s, st in eng._slots.items() if st.uid == uid), None)
    return s is not None and bool(eng._active[s]) and \
        len(eng._slots[s].out) >= n


def _steps(eng, done, until, max_steps=500):
    for _ in range(max_steps):
        if until():
            return
        for c in eng.step():
            done[c.uid] = c
        eng.kv.verify()
    raise AssertionError("the engine never got there")


def _preempt_serve(eng):
    """The three requests until each decodes 8 tokens, then the arrival;
    drained. Returns (completions by uid, uids)."""
    lows, high = _low_reqs()
    done = {}
    uids = [eng.add_request(**r) for r in lows]
    _steps(eng, done, lambda: all(_decoding(eng, u, 8) for u in uids))
    uids.append(eng.add_request(**high))
    _steps(eng, done, lambda: not eng.has_work)
    return done, uids


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_captured_preempt_resume_equals_the_eager_engine(cuda, kv_dtype,
                                                         mixed):
    """Preemption tears a slot down between replays, releases and reuses
    its pages and carries a sampled slot's generator across the
    re-admission: the captured engine gives the eager engine's tokens,
    logits and counters, and captures nothing more."""
    runs = []
    for capture in (True, False):
        eng = _graph_engine(cuda, capture, kv_dtype=kv_dtype,
                            mixed_step=mixed, num_pages=RES_POOL)
        n = eng.stats["graph_captures"]
        done, uids = _preempt_serve(eng)
        torch.cuda.synchronize()
        assert eng.stats["graph_captures"] == n
        assert eng.kv.num_in_use == 0
        runs.append(([done[u].tokens for u in uids],
                     [done[u].preemptions for u in uids],
                     [eng.logit_log[u] for u in uids], dict(eng.stats)))
    (tc, pc, lc, sc), (te, pe, le, se) = runs
    assert tc == te and pc == pe
    assert sc["preemptions"] >= 1 and sc["resumes"] >= 1 and pc[2] >= 1
    for a, b in zip(lc, le):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for key in sc:
        if not key.startswith("graph_"):
            assert sc[key] == se[key], key


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_graph_captures_are_fixed_through_every_drill(cuda, mixed):
    """Preemption and resume, cancels while queued, prefilling and
    decoding, a deadline of 0, a shed, each per-request fault kind,
    replica_down and close(): no graph is captured after the
    constructor, every fault fails only its target, and the pool
    verifies after each."""
    from paddle_tpu_torch.inference import FaultInjector, ReplicaDown
    inj = FaultInjector()
    eng = _graph_engine(cuda, True, mixed_step=mixed, num_pages=RES_POOL,
                        max_queue=3, shed_policy="shed_oldest",
                        fault_injector=inj)
    n = eng.stats["graph_captures"]
    done, uids = _preempt_serve(eng)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["graph_captures"] == n
    lows, high = _low_reqs()
    rng = np.random.RandomState(42)
    a, b = (eng.add_request(**r) for r in lows[:2])
    _steps(eng, done, lambda: _decoding(eng, a) and _decoding(eng, b))
    inj.inject("decode_error", uid=a).inject("nonfinite_logits", uid=b)
    c = eng.add_request(rng.randint(0, 128, 20), 6)
    inj.inject("prefill_error", uid=c).inject("stall")
    d = eng.add_request(rng.randint(0, 128, 12), 6)
    inj.inject("page_exhaustion", uid=d)
    _steps(eng, done, lambda: not inj.armed and not eng._pending)
    shed = eng.add_request(rng.randint(0, 128, 12), 4)
    gone = eng.add_request(rng.randint(0, 128, 12), 4, deadline_s=0.0)
    q = eng.add_request(rng.randint(0, 128, 12), 4)
    eng.cancel(q)
    eng.add_request(rng.randint(0, 128, 12), 4)   # sheds the oldest
    _steps(eng, done, lambda: gone in done and q in done)
    long = eng.add_request(rng.randint(0, 128, 70), 4)
    _steps(eng, done, lambda: any(st.uid == long and 0 < st.pf_base
                                  < st.pf_end
                                  for st in eng._slots.values()))
    eng.cancel(long)
    dec = eng.add_request(rng.randint(0, 128, 10), 40)
    _steps(eng, done, lambda: _decoding(eng, dec, 2))
    eng.cancel(dec)
    _steps(eng, done, lambda: not eng.has_work)
    assert eng.stats["graph_captures"] == n
    want = {a: "error", b: "nonfinite", c: "error", d: "length",
            gone: "deadline", q: "cancelled", shed: "shed",
            long: "cancelled", dec: "cancelled"}
    assert {u: done[u].finish_reason for u in want} == want
    assert {c.finish_reason for u, c in done.items() if u not in want} \
        == {"length"}
    assert eng.stats["faults"] == 5
    eng.add_request(**lows[0])
    _steps(eng, done, lambda: any(eng._active))
    inj.inject("replica_down")
    with pytest.raises(ReplicaDown):
        eng.step()
    eng.kv.verify()
    assert eng.kv.num_in_use == 0
    eng.add_request(**lows[0])
    eng.add_request(**high)
    _steps(eng, done, lambda: any(eng._active))
    aborted = eng.close()
    assert aborted and {c.finish_reason for c in aborted.values()} \
        <= {"aborted", "error"}
    eng.kv.verify()
    assert eng.kv.num_in_use == 0 and not eng.has_work
    assert eng.close() == {}
    assert eng.stats["graph_captures"] == n


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("program", ["decode_step", "decode_block",
                                     "mixed"])
def test_pages_no_live_slot_holds_survive_the_replay_after_an_abort(
        cuda, kv_dtype, program):
    """A cancelled decoding slot is torn down between two replays: its
    host mirrors are cleared, so in the next replay of the decode step,
    a fused block or the mixed program its row writes the trash page
    only. Every page (and scale row) that no live slot holds keeps its
    bytes across that replay, the torn-down slot's pages among them."""
    kw = {"decode_step": dict(decode_block=1),
          "decode_block": dict(decode_block=4),
          "mixed": dict(mixed_step=True)}[program]
    eng = _graph_engine(cuda, True, kv_dtype=kv_dtype, **kw)
    lows, _ = _low_reqs()
    done = {}
    uids = [eng.add_request(**r) for r in lows]
    _steps(eng, done, lambda: all(_decoding(eng, u, 2) for u in uids))
    kv = eng.kv
    tensors = (*kv.k, *kv.v, *kv.k_scale, *kv.v_scale)
    torch.cuda.synchronize()
    before = [t.view(torch.uint8).clone() for t in tensors]
    victim = next(st for st in eng._slots.values() if st.uid == uids[1])
    keep = {0} | {p for st in eng._slots.values() if st is not victim
                  for p in st.pages}
    held = sorted(set(range(kv.num_pages)) - keep)
    assert set(victim.pages) <= set(held)
    keys = []
    replay = eng._replay
    eng._replay = lambda key, *h: (keys.append(key), replay(key, *h))[1]
    eng.cancel(uids[1])
    for c in eng.step():
        done[c.uid] = c
    torch.cuda.synchronize()
    assert keys == [{"decode_step": 1, "decode_block": 4,
                     "mixed": "mixed"}[program]]
    assert done[uids[1]].finish_reason == "cancelled"
    idx = torch.tensor(held, device=cuda)
    for t, b in zip(tensors, before):
        assert torch.equal(t.view(torch.uint8)[idx], b[idx])
    del eng._replay
    _steps(eng, done, lambda: not eng.has_work)
    assert eng.kv.num_in_use == 0


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_close_releases_every_page_of_the_captured_engine(cuda, mixed):
    eng = _graph_engine(cuda, True, mixed_step=mixed, num_pages=RES_POOL)
    lows, high = _low_reqs()
    done = {}
    uids = [eng.add_request(**r) for r in lows]
    _steps(eng, done, lambda: _decoding(eng, uids[0], 2))
    uids.append(eng.add_request(**high))
    aborted = eng.close()
    assert sorted(aborted) == sorted(uids)
    assert {c.finish_reason for c in aborted.values()} == {"aborted"}
    eng.kv.verify()
    assert eng.kv.num_in_use == 0 and not eng.has_work


# -- speculative decoding on the captured engine --------------------------------

SPEC_KW = dict(speculative=1, draft_k=3)


@pytest.mark.parametrize("kv_dtype,weight_dtype", [
    ("bf16", None), ("int8", None), ("fp8", None), ("bf16", "int8")])
@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_captured_spec_engine_equals_the_eager_engine_bit_for_bit(
        cuda, kv_dtype, weight_dtype, mixed):
    """Speculative rounds (the propose scan, the verify program or the
    mixed program's verify rows, the mirror step and the draft's prefill
    and page copy) captured and eager, over bf16, int8 and fp8 pools and
    with int8 weights: tokens, logged logits and launch counters
    identical."""
    runs = []
    for capture in (True, False):
        eng = _graph_engine(cuda, capture, kv_dtype=kv_dtype,
                            weight_dtype=weight_dtype, mixed_step=mixed,
                            **SPEC_KW)
        pa.reset_launches()
        toks = _graph_serve(eng, _graph_reqs())
        torch.cuda.synchronize()
        runs.append((toks, [eng.logit_log[u] for u in sorted(eng.logit_log)],
                     [getattr(pa, c) for c in COUNTS], dict(eng.stats)))
    (tc, lc, cc, sc), (te, le, ce, se) = runs
    assert tc == te
    for a, b in zip(lc, le):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cc == ce and sum(cc) > 0
    assert sc["spec_rounds"] > 0 and sc["spec_rejected"] > 0
    # the draft's page copy replays beside the target's
    assert sc["graph_replays"] == sc["dispatches"] + 2 * sc["cow_copies"]
    for key in sc:
        if not key.startswith("graph_"):
            assert sc[key] == se[key], key


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_spec_graph_captures_are_fixed_after_construction(cuda, mixed):
    """Every program a speculative engine can dispatch is captured in the
    constructor — per phase the prefill chunk, the decode step, the
    verify program and the page copy (no fused block), or the mixed
    program and the page copy, and the draft's page copy, prefill chunk,
    mirror step and propose scan — and none after it; each graph's
    launch deltas are its program's (target or draft layers)."""
    eng = _graph_engine(cuda, True, mixed_step=mixed, **SPEC_KW)
    keys = (["copy_page", "mixed"] if mixed else
            ["copy_page", "prefill", 1, "verify"]) + \
        ["draft_copy", "draft_prefill", "mirror", "propose"]
    assert list(eng._progs) == keys
    n = eng.stats["graph_captures"]
    assert n == len(keys)
    L, dL, k = gpt2_tiny().num_layers, 1, SPEC_KW["draft_k"]
    per = {"copy_page": 0, "prefill": L, 1: L, "verify": L, "mixed": L,
           "draft_copy": 0, "draft_prefill": dL, "mirror": dL,
           "propose": dL * (k + 1)}
    for key, prog in eng._progs.items():
        assert prog.deltas == [per[key]] * 2 + [0, 0], key
    first = _graph_serve(eng, _graph_reqs())
    second = _graph_serve(eng, _graph_reqs())
    assert eng.stats["graph_captures"] == n
    # greedy streams repeat; a sampled one may not: the second serve finds
    # the shared prefix cached, so rounds fall on other steps, and a round
    # draws otherwise than plain steps
    greedy = [i for i, r in enumerate(_graph_reqs()) if r[2] == 0]
    assert [first[i] for i in greedy] == [second[i] for i in greedy]
    assert eng.stats["spec_rounds"] > 0 and eng.stats["cow_copies"] > 0


def test_the_verify_replay_traces_its_recorded_kernels(cuda):
    """One replay of the verify graph under ``torch.profiler``: the ragged
    kernels the device ran (split-KV split and merge) equal the launches
    the graph recorded at its capture."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = _graph_engine(cuda, True, **SPEC_KW)
    prog = eng._progs["verify"]
    S = eng.num_slots
    nsplit = pa.split_plan(S, SPEC_KW["draft_k"] + 1, eng.cfg.num_heads,
                           eng.page_size, eng.pages_per_slot)[1]
    want = {"split": prog.deltas[1],
            "merge": prog.deltas[1] * (nsplit > 1)}
    assert want["split"] == eng.cfg.num_layers
    for _ in range(3):      # the profiler can lose a record: trace again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.replay(*eng._idle_host("verify"))
            torch.cuda.synchronize()
        got = dict.fromkeys(want, 0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for kind in got:
                    got[kind] += f"ragged_paged_attention_{kind}_kernel" \
                        in e.name
        if got == want:
            break
    assert got == want


# -- the split-KV design of the float-pool kernel ------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["mixed", "decode", "prefill", "verify"])
def test_split_kv_kernel_matches_plain_at_the_smoke_shapes(cuda, shape, dtype,
                                                           tol):
    """GPT-2 small's serving shapes (chip_smoke.RAGGED_SHAPES): every call
    on the split-KV design, live rows within the limit, idle slots exactly
    zero, two launches bit-identical."""
    import chip_smoke
    kv_lens, q_lens, QB = chip_smoke.RAGGED_SHAPES[shape]
    c = chip_smoke.attention_case(kv_lens, q_lens, QB, dtype,
                                  np.random.default_rng(3), 1)
    kp, vp = c["pools"][0]
    args = (c["q"], kp, vp, c["bt"], c["kv_lens"], c["q_lens"])
    assert pa.split_kv(c["q"], kp, vp)
    pa.reset_launches()
    runs = [pa.ragged_paged_attention(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert (pa.launches, pa.split_launches, pa.quant_launches) == (2, 2, 0)
    assert torch.equal(runs[0], runs[1])
    ref = pa.ragged_paged_attention_ref(*args)
    assert _live_err(runs[0], ref, c["q_lens"]) <= tol
    idle = c["kv_lens"] == 0
    assert torch.all(runs[0][idle] == 0)


@pytest.mark.parametrize("split_len", [8, 16, 24, 32])
def test_split_kv_kernel_at_forced_split_lengths(cuda, split_len):
    """The C entry at split lengths the wrapper would not pick: splits that
    cut a slot's extent inside its run of pages, a slot shorter than one
    split, and one split (the block writes the output itself)."""
    q, k, v, bt, kl, ql = _case(cuda, 13)
    fn = pa._kernel_fn("paged_attention_forward_split", pa.SPLIT_ARGTYPES)
    S, QB, NH, HD = q.shape
    PS, MP = k.shape[1], bt.shape[1]
    nsplit = -(-MP * PS // split_len)
    out = torch.empty_like(q)
    ws = torch.empty(S * QB * NH * nsplit * (HD + 2), dtype=torch.float32,
                     device=cuda)
    rc = fn(0, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(),
            kl.data_ptr(), ql.data_ptr(), out.data_ptr(), ws.data_ptr(), S, QB,
            NH, HD, PS, MP, split_len, nsplit, HD ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    ref = pa.ragged_paged_attention_ref(q, k, v, bt, kl, ql)
    assert _live_err(out, ref, ql) <= 1e-4
    assert torch.all(out[3] == 0)


def test_quantized_pools_keep_the_first_design(cuda):
    """Where ``split_kv`` refuses a code pool (a head size off whole
    16-code units, a pool not 16-byte aligned) the first design runs,
    over int8 and fp8 codes alike."""
    for fmt, HD, unaligned in ((f, hd, u) for f in ("int8", "fp8")
                               for hd, u in ((24, False), (64, True))):
        (q, bt, kl, ql), kq, vq, ks, vs = _quant_case(
            cuda, 24, fmt, torch.bfloat16, HD, unaligned=unaligned)
        assert not pa.split_kv(q, kq, vq, ks, vs)
        pa.reset_launches()
        pa.ragged_paged_attention(q, kq, vq, bt, kl, ql, k_scale=ks,
                                  v_scale=vs)
        torch.cuda.synchronize()
        assert (pa.launches, pa.split_launches, pa.quant_launches,
                pa.quant_split_launches) == (0, 0, 1, 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", ["mixed", "decode", "prefill", "verify"])
def test_quant_split_kv_kernel_matches_plain_at_the_smoke_shapes(
        cuda, shape, fmt, dtype, tol):
    """GPT-2 small's serving shapes over int8 / fp8 pools
    (chip_smoke.quant_attention_case: pages and heads of very different
    magnitude): every call on the split-KV design over codes as the
    wrapper routes it, live rows within the limit of max-abs, idle slots
    exactly zero, two launches bit-identical."""
    import chip_smoke
    kv_lens, q_lens, QB = chip_smoke.RAGGED_SHAPES[shape]
    c = chip_smoke.quant_attention_case(kv_lens, q_lens, QB, dtype, fmt,
                                        np.random.default_rng(4), 1)
    (kp, vp), (ks, vs) = c["pools"][0], c["scales"][0]
    args = (c["q"], kp, vp, c["bt"], c["kv_lens"], c["q_lens"])
    assert pa.split_kv(c["q"], kp, vp, ks, vs)
    pa.reset_launches()
    runs = [pa.ragged_paged_attention(*args, k_scale=ks, v_scale=vs)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (pa.launches, pa.quant_launches, pa.quant_split_launches) == \
        (0, 2, 2)
    assert torch.equal(runs[0], runs[1])
    ref = pa.ragged_paged_attention_ref(*args, k_scale=ks, v_scale=vs)
    assert _live_err(runs[0], ref, c["q_lens"]) <= \
        tol * float(ref.float().abs().max())
    idle = c["kv_lens"] == 0
    assert torch.all(runs[0][idle] == 0)


@pytest.mark.parametrize("HD", [16, 64, 128])
@pytest.mark.parametrize("split_len", [8, 16, 24, 32])
def test_quant_split_kv_kernel_at_forced_split_lengths(cuda, split_len, HD):
    """The code-pool C entry at split lengths the wrapper would not pick,
    at head sizes of one, four (groups of 4 lanes) and eight 16-code
    units (groups of 8)."""
    (q, bt, kl, ql), kq, vq, ks, vs = _quant_case(cuda, 25, "fp8",
                                                  torch.float32, HD)
    fn = pa._kernel_fn("paged_attention_forward_split_quant",
                       pa.SPLIT_QUANT_ARGTYPES)
    S, QB, NH, _ = q.shape
    PS, MP = kq.shape[1], bt.shape[1]
    nsplit = -(-MP * PS // split_len)
    out = torch.empty_like(q)
    ws = torch.empty(S * QB * NH * nsplit * (HD + 2), dtype=torch.float32,
                     device=cuda)
    rc = fn(0, 3, q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), bt.data_ptr(), kl.data_ptr(), ql.data_ptr(),
            out.data_ptr(), ws.data_ptr(), S, QB, NH, HD, PS, MP, split_len,
            nsplit, HD ** -0.5, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    ref = pa.ragged_paged_attention_ref(q, kq, vq, bt, kl, ql, k_scale=ks,
                                        v_scale=vs)
    assert _live_err(out, ref, ql) <= 1e-4 * float(ref.abs().max())
    assert torch.all(out[3] == 0)


# -- flash attention (paddle_tpu_torch/kernels/flash_attention.py) ------------

FA_CASES = {            # B, H, Lq, Lk, D, causal
    "causal1024": (2, 3, 1024, 1024, 64, True),
    "ragged1000": (2, 3, 1000, 1000, 64, True),
    "cross128x256": (2, 3, 128, 256, 64, False),
    "causal128x256": (2, 3, 128, 256, 64, True),
    "causal256x128": (2, 3, 256, 128, 64, True),
    "streamed4096": (1, 2, 4096, 4096, 64, True),
    "d128": (2, 3, 320, 320, 128, True),
    # a head size the wgmma forward does not serve: bf16 takes the
    # CUDA-core forward here
    "d32": (2, 3, 200, 200, 32, True),
}
FA_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)}


def _fa_inputs(dev, B, H, Lq, Lk, D, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*s, generator=g).to(device=dev, dtype=dtype)
            for s in ((B, Lq, H, D), (B, Lk, H, D), (B, Lk, H, D),
                      (B, Lq, H, D))]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_kernels_match_plain(cuda, case, dtype):
    from paddle_tpu_torch.kernels import flash_attention as fa
    B, H, Lq, Lk, D, causal = FA_CASES[case]
    q, k, v, do = _fa_inputs(cuda, B, H, Lq, Lk, D, dtype)
    fa.reset_launches()
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = fa.attention_delta(out, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (1, 1, 1)
    # bf16 takes the wgmma/TMA kernels (forward at D = 64 / 128, backward
    # at D = 64), the rest the others
    bf16 = dtype == torch.bfloat16
    assert fa.fwd_hopper_launches == (bf16 and D in (64, 128))
    assert (fa.dq_hopper_launches, fa.dkv_hopper_launches) == (
        bf16 and D == 64, bf16 and D == 64)
    rout, rlse = fa.flash_attention_fwd_ref(q, k, v, causal)
    rdq = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal)
    rdk, rdv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                              causal)
    ftol, gtol = FA_TOL[dtype]
    assert _rel(out, rout) <= ftol and _rel(lse, rlse) <= ftol
    for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= gtol, name


def test_flash_backward_is_bit_identical_across_launches(cuda):
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, do = _fa_inputs(cuda, 2, 3, 1024, 1024, 64, torch.bfloat16, 5)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.attention_delta(out, do)
    fa.reset_launches()
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
            for _ in range(2)]
    assert (fa.dq_hopper_launches, fa.dkv_hopper_launches) == (2, 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["causal1024", "ragged1000",
                                  "causal256x128", "d128"])
def test_flash_forward_is_bit_identical_across_launches(cuda, case):
    """The wgmma/TMA forward sums every row in one fixed order (no
    atomics, no split of the keys): two launches agree bit for bit."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    B, H, Lq, Lk, D, causal = FA_CASES[case]
    q, k, v, _ = _fa_inputs(cuda, B, H, Lq, Lk, D, torch.bfloat16, 6)
    fa.reset_launches()
    runs = [fa.flash_attention_fwd(q, k, v, causal) for _ in range(2)]
    assert fa.fwd_hopper_launches == 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_flash_forward_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma forward built with its test hook FLASH_FWD_STALL_WG,
    which sleeps one consumer warpgroup on every key tile so the other
    runs ahead (under causality the two read different numbers of
    tiles): the producer must still reload no stage that the lagging
    warpgroup reads, so the output equals the plain build's bit for
    bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    lib = _build.load("flash_attention", (f"-DFLASH_FWD_STALL_WG={stalled}",))
    fn = lib.flash_attention_forward_hopper
    fn.argtypes, fn.restype = fa.FWD_ARGTYPES, ctypes.c_int
    for case in ("causal1024", "ragged1000", "causal256x128",
                 "causal128x256", "d128"):
        B, H, Lq, Lk, D, causal = FA_CASES[case]
        q, k, v, _ = _fa_inputs(cuda, B, H, Lq, Lk, D, torch.bfloat16, 7)
        want = fa.flash_attention_fwd(q, k, v, causal)
        out = torch.empty_like(q)
        lse = torch.empty(B * H, Lq, dtype=torch.float32, device=cuda)
        scale = fa._default_scale(q, None)
        rc = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *fa._dims(q, k, scale, causal))
        assert rc == 0, case
        torch.cuda.synchronize()
        assert torch.equal(out, want[0]) and torch.equal(lse, want[1]), case


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_flash_backward_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma dq and dk/dv built with their test hook
    FLASH_BWD_STALL_WG, which sleeps one consumer warpgroup on every tile
    of both kernels so the other runs ahead (under causality the two read
    different numbers of tiles, and in dk/dv the lower keys' warpgroup
    reads a q tile the upper one skips): the producer must still reload
    no stage that the lagging warpgroup reads, so the gradients equal the
    plain build's bit for bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    lib = _build.load("flash_attention", (f"-DFLASH_BWD_STALL_WG={stalled}",))
    fdq = lib.flash_attention_backward_dq_hopper
    fdkv = lib.flash_attention_backward_dkv_hopper
    fdq.argtypes, fdq.restype = fa.DQ_ARGTYPES, ctypes.c_int
    fdkv.argtypes, fdkv.restype = fa.DKV_ARGTYPES, ctypes.c_int
    for case in ("causal1024", "ragged1000", "causal256x128",
                 "causal128x256", "cross128x256", "streamed4096"):
        B, H, Lq, Lk, D, causal = FA_CASES[case]
        q, k, v, do = _fa_inputs(cuda, B, H, Lq, Lk, D, torch.bfloat16, 8)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = fa.attention_delta(out, do)
        want = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
                *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        dims = fa._dims(q, k, fa._default_scale(q, None), causal)
        assert fdq(1, *ptrs, dq.data_ptr(), *dims) == 0, case
        assert fdkv(1, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims) == 0, case
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert torch.equal(a, b), (case, name)


def test_tiny_training_step_with_the_kernels_equals_the_plain_step(cuda):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 128, (3, 2, 40))
    labels = np.roll(ids, -1, axis=-1)
    runs = {}
    for plain in (False, True):
        m = GPTForCausalLM(gpt2_tiny(dropout=0.0, bf16_residual=False),
                           device=cuda, seed=3)
        step = TrainStep(m, lambda m_, i, y: m_.loss(i, y), AdamW(1e-3),
                         device=cuda)
        fa.reset_launches()
        if plain:
            with fa.use_plain():
                losses = step.multi_step(ids, labels)
        else:
            losses = step.multi_step(ids, labels)
        launches = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
        assert launches == ((0, 0, 0) if plain else (6, 6, 6))
        runs[plain] = (losses.cpu(), {n: p.detach().cpu()
                                      for n, p in m.named_parameters()})
    torch.testing.assert_close(runs[False][0], runs[True][0], rtol=1e-5,
                               atol=1e-5)
    H = 64
    for name, a in runs[False][1].items():
        b = runs[True][1][name]
        if name.endswith("attn.qkv.bias"):
            # the key bias's exact gradient is zero (softmax ignores a
            # constant per query); Adam scales the rounding noise on both
            # sides to steps of about lr, 3 steps of 1e-3 at most
            torch.testing.assert_close(a[H:2 * H], b[H:2 * H], rtol=0,
                                       atol=2 * 3 * 1e-3)
            a, b = torch.cat([a[:H], a[2 * H:]]), torch.cat([b[:H],
                                                             b[2 * H:]])
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


def test_flash_wrapper_raises_on_cuda_without_the_library(cuda, tmp_path,
                                                          monkeypatch):
    """No fallback: with the library unbuildable a CUDA tensor raises."""
    import torch.utils.cpp_extension as ext
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(fa, "_fns", {})
    q, k, v, _ = _fa_inputs(cuda, 1, 2, 64, 64, 64, torch.float32)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.flash_attention(q, k, v, causal=True)


# -- fused head + CE (paddle_tpu_torch/kernels/fused_ce.py) -------------------

FCE_CASES = {           # T, V, d: ragged tails, d off the vector width
    "ragged": (300, 500, 64),
    "vocab50257": (1000, 50257, 64),
    "d96": (257, 1000, 96),
    "d50_scalar_loads": (130, 333, 50),
    # GPT-2's width: three 256-column tiles of the wgmma dw_sharep, and
    # 1000 vocab rows past its last 128-row block edge
    "gpt_width": (257, 1000, 768),
}
# (nll/lse, dh/dw): float32 sums of float32 logits on both sides for
# nll/lse; bf16 gradients differ by at most one rounding step of the output
FCE_TOL = {torch.float32: (2e-6, 1e-4), torch.bfloat16: (2e-6, 1e-2)}


def _fce_inputs(dev, T, V, d, dtype, seed=0):
    """h, w, int32 labels (a third -100, with g = 0; every 16th from row
    1 past the vocabulary with its g kept: a softmax-only row) and g."""
    rng = np.random.RandomState(seed)
    h = torch.tensor(rng.randn(T, d), dtype=torch.float32)
    w = torch.tensor(rng.randn(V, d) * 0.1, dtype=torch.float32)
    lab = torch.tensor(rng.randint(0, V, T), dtype=torch.int32)
    lab[1::16] = V + 7
    lab[::3] = -100
    g = torch.tensor(rng.rand(T) / T, dtype=torch.float32)
    g[::3] = 0.0
    return (h.to(dev, dtype), w.to(dev, dtype), lab.to(dev), g.to(dev))


def _softmax_parts(lab, g, V, dh, dw):
    """dh on rows whose label picks nothing (g not 0) and dw on the vocab
    rows no label picks: there the softmax term is all of the gradient,
    where elsewhere the one-hot term outweighs it many times over."""
    picks = (lab >= 0) & (lab < V)
    free = torch.ones(V, dtype=torch.bool, device=dw.device)
    free[lab[picks].long()] = False
    return dh[~picks & (g != 0)], dw[free]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FCE_CASES))
def test_fused_ce_kernels_match_plain(cuda, case, dtype):
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, lab, g = _fce_inputs(cuda, *FCE_CASES[case], dtype)
    fc.reset_launches()
    nll, lse = fc.fused_ce_fwd(h, w, lab)
    dh = fc.fused_ce_bwd_dh(h, w, lab, lse, g)
    dw = fc.fused_ce_bwd_dw(h, w, lab, lse, g)
    torch.cuda.synchronize()
    assert (fc.fwd_launches, fc.dh_launches, fc.dw_launches) == (1, 1, 1)
    # bf16 with d % 8 == 0 on the wgmma/TMA forward, dh and dw; float32
    # and d = 50 not
    assert fc.dw_hopper_launches == int(dtype == torch.bfloat16
                                        and h.shape[1] % 8 == 0)
    assert fc.dh_hopper_launches == fc.dw_hopper_launches
    assert fc.fwd_hopper_launches == fc.dw_hopper_launches
    rnll, rlse = fc.fused_ce_fwd_ref(h, w, lab)
    rdh = fc.fused_ce_bwd_dh_ref(h, w, lab, lse, g)
    rdw = fc.fused_ce_bwd_dw_ref(h, w, lab, lse, g)
    ftol, gtol = FCE_TOL[dtype]
    assert _rel(nll, rnll) <= ftol and _rel(lse, rlse) <= ftol
    none = (lab < 0) | (lab >= w.shape[0])
    torch.testing.assert_close(nll[none], lse[none], rtol=0, atol=0)
    sdh, sdw = _softmax_parts(lab, g, w.shape[0], dh, dw)
    srdh, srdw = _softmax_parts(lab, g, w.shape[0], rdh, rdw)
    assert sdh.shape[0] > 0 and sdw.shape[0] > 0
    for name, a, b in (("dh", dh, rdh), ("dw", dw, rdw),
                       ("dh_softmax", sdh, srdh), ("dw_softmax", sdw, srdw)):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= gtol, (name, _rel(a, b))
    assert torch.all(dh[::3] == 0)      # g = 0 rows: exactly no gradient


def test_forward_splits_fill_the_card(cuda):
    """The C side's vocab split counts, each split at least 1024 columns
    wide: the first design's about two forward blocks an SM (64-token
    bf16 tiles, 32-token float32 ones); the wgmma design's one 64-token
    block an SM in whole waves while the blocks are fewer than the SMs,
    one split from there on, bf16 only. A forced single split gives the
    same answer."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    fn = fc._kernel_fn("fused_ce_forward_splits", fc.SPLITS_ARGTYPES)
    hfn = fc._kernel_fn("fused_ce_forward_hopper_splits", fc.SPLITS_ARGTYPES)
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = ((16384, 50304), (1000, 50257), (2048, 50304), (40, 300),
              (300, 5000))
    for code, bt in ((1, 64), (0, 32)):
        for T, V in shapes:
            want = max(1, min(-(-2 * sms // -(-T // bt)), -(-V // 1024)))
            assert fn(code, T, V, dev) == want, (code, T, V)
    for T, V in shapes:
        blocks = -(-T // 64)
        want = 1 if blocks >= sms else max(1, min(sms // blocks,
                                                  -(-V // 1024)))
        assert hfn(1, T, V, dev) == want, (T, V)
    assert fn(2, 10, 10, dev) == 0      # no such dtype
    assert hfn(0, 10, 10, dev) == 0     # float32 takes the first design
    h, w, lab, _ = _fce_inputs(cuda, 1000, 50257, 64, torch.bfloat16, 2)
    split = fc.fused_ce_fwd(h, w, lab)
    whole = fc._launch_fwd(h, w, lab, nsplit=1)
    for a, b in zip(split, whole):
        assert _rel(a, b) <= 2e-6


def test_fused_ce_backward_is_bit_identical_across_launches(cuda):
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, lab, g = _fce_inputs(cuda, 700, 3000, 64, torch.bfloat16, 5)
    _, lse = fc.fused_ce_fwd(h, w, lab)
    runs = [(fc.fused_ce_bwd_dh(h, w, lab, lse, g),
             fc.fused_ce_bwd_dw(h, w, lab, lse, g)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,V", [(1000, 50257), (257, 1000), (33, 300)],
                         ids=["vocab50257", "v1000", "one_tile_and_a_row"])
def test_fused_ce_dw_wgmma_matches_plain_at_gpt_width(cuda, T, V):
    """The wgmma/TMA dw at GPT-2's d = 768 (both warpgroups' halves of d):
    against the plain dw within 1e-2 of max-abs, its softmax-only rows
    (vocab rows no label picks) within the same limit of their own
    max-abs, rows with g = 0 contributing nothing, and two launches
    bit-identical."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, lab, g = _fce_inputs(cuda, T, V, 768, torch.bfloat16, 9)
    _, lse = fc.fused_ce_fwd(h, w, lab)
    fc.reset_launches()
    runs = [fc.fused_ce_bwd_dw(h, w, lab, lse, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fc.dw_launches, fc.dw_hopper_launches) == (2, 2)
    assert torch.equal(runs[0], runs[1])
    rdw = fc.fused_ce_bwd_dw_ref(h, w, lab, lse, g)
    _, sdw = _softmax_parts(lab, g, V, h, runs[0])
    _, srdw = _softmax_parts(lab, g, V, h, rdw)
    assert sdw.shape[0] > 0
    assert _rel(runs[0], rdw) <= FCE_TOL[torch.bfloat16][1]
    assert _rel(sdw, srdw) <= FCE_TOL[torch.bfloat16][1]
    # the g = 0 rows (a third) weigh nothing: dropping them changes nothing
    keep = g != 0
    alone = fc.fused_ce_bwd_dw(h[keep].contiguous(), w, lab[keep].contiguous(),
                               lse[keep].contiguous(), g[keep].contiguous())
    assert _rel(alone, runs[0]) <= FCE_TOL[torch.bfloat16][1]


@pytest.mark.parametrize("d", [136, 384, 392, 640, 648])
def test_fused_ce_dw_wgmma_at_the_chunk_edges(cuda, d):
    """The wgmma/TMA dw loads and multiplies only the 128-column chunks of
    d that hold columns (warpgroup 0 owns chunks 0-2, warpgroup 1 chunks
    3-5): at d = 136 and 384 the second warpgroup has none, at 392 and
    640 some, at 648 all of them on the general build. Against the plain
    dw within 1e-2 of max-abs."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, lab, g = _fce_inputs(cuda, 200, 700, d, torch.bfloat16, 11)
    _, lse = fc.fused_ce_fwd(h, w, lab)
    fc.reset_launches()
    dw = fc.fused_ce_bwd_dw(h, w, lab, lse, g)
    torch.cuda.synchronize()
    assert fc.dw_hopper_launches == 1
    assert _rel(dw, fc.fused_ce_bwd_dw_ref(h, w, lab, lse, g)) <= \
        FCE_TOL[torch.bfloat16][1]


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_fused_ce_dw_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma dw built with its test hook FUSED_CE_DW_STALL_WG, which
    sleeps one consumer warpgroup on every token tile so the other runs
    ahead to the shared partial logits: the exchange buffers, the stage
    statistics and the ring must still hold each tile's values until both
    have read them, so dw equals the plain build's bit for bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as fc
    lib = _build.load("fused_ce", (f"-DFUSED_CE_DW_STALL_WG={stalled}",))
    fn = lib.fused_ce_backward_dw_hopper
    fn.argtypes, fn.restype = fc.BWD_ARGTYPES, ctypes.c_int
    for T, V, d in ((1000, 50257, 768), (257, 1000, 96)):
        h, w, lab, g = _fce_inputs(cuda, T, V, d, torch.bfloat16, 10)
        _, lse = fc.fused_ce_fwd(h, w, lab)
        want = fc.fused_ce_bwd_dw(h, w, lab, lse, g)
        out = torch.empty_like(w)
        rc = fn(1, h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                g.data_ptr(), out.data_ptr(), T, V, d,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (T, V, d)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (T, V, d)


# T, V, d of the wgmma/TMA dh and dh_sharep: ragged T and V at GPT-2's
# width (the build with every 128-column chunk live) and at small d (the
# build that loads and multiplies only the chunks that hold d)
FCE_DH_CASES = {
    "vocab50257": (1000, 50257, 768),
    "v1000": (257, 1000, 768),
    "one_tile_and_a_row": (65, 33, 768),
    "d64": (300, 500, 64),
    "d136": (130, 333, 136),
    "d648": (200, 700, 648),
}


@pytest.mark.parametrize("case", list(FCE_DH_CASES))
def test_fused_ce_dh_wgmma_matches_plain(cuda, case):
    """The wgmma/TMA dh and dh_sharep: dh against the plain dh within
    1e-2 of max-abs, its softmax-only rows (labels past the vocabulary)
    within the same limit of their own max-abs, g = 0 rows exactly 0; two
    launches of each bit-identical; dh_sharep's dh equal to dh bit for
    bit (the stored dl is the tile that fed it), its dl within one bf16
    step of the plain dl, zero in the columns the rows are padded to and
    on g = 0 rows."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    T, V, d = FCE_DH_CASES[case]
    h, w, lab, g = _fce_inputs(cuda, T, V, d, torch.bfloat16, 12)
    _, lse = fc.fused_ce_fwd(h, w, lab)
    fc.reset_launches()
    runs = [fc.fused_ce_bwd_dh(h, w, lab, lse, g) for _ in range(2)]
    pairs = [fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fc.dh_launches, fc.dh_hopper_launches) == (2, 2)
    assert (fc.dh_sharep_launches, fc.dh_sharep_hopper_launches) == (2, 2)
    dh, (sdh, dl) = runs[0], pairs[0]
    assert torch.equal(dh, runs[1])
    assert torch.equal(sdh, pairs[1][0]) and torch.equal(dl, pairs[1][1])
    assert torch.equal(sdh, dh)
    rdh, rdl = fc.fused_ce_bwd_dh_sharep_ref(h, w, lab, lse, g)
    soft, _ = _softmax_parts(lab, g, V, dh, w)
    rsoft, _ = _softmax_parts(lab, g, V, rdh, w)
    assert soft.shape[0] > 0
    gtol = FCE_TOL[torch.bfloat16][1]
    assert bool(torch.isfinite(dh).all())
    assert _rel(dh, rdh) <= gtol, _rel(dh, rdh)
    assert _rel(soft, rsoft) <= gtol, _rel(soft, rsoft)
    assert torch.all(dh[::3] == 0)
    assert dl.shape == (T, V) and dl.stride(0) == -(-V // 8) * 8
    assert int(_bf16_steps(dl, rdl).max()) <= 1
    tail = torch.as_strided(dl, (T, dl.stride(0) - V), (dl.stride(0), 1), V)
    assert not tail.any()
    assert not dl[::3].any()


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_fused_ce_dh_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma dh and dh_sharep built with their test hook
    FUSED_CE_DH_STALL_WG, which sleeps one consumer warpgroup on every
    vocab tile so the other runs ahead to the shared partial logits: the
    exchange buffers and the ring must still hold each tile's values
    until both have read them, so dh and dl equal the plain build's bit
    for bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as fc
    lib = _build.load("fused_ce", (f"-DFUSED_CE_DH_STALL_WG={stalled}",))
    dh_fn = lib.fused_ce_backward_dh_hopper
    dh_fn.argtypes, dh_fn.restype = fc.BWD_ARGTYPES, ctypes.c_int
    sp_fn = lib.fused_ce_backward_dh_sharep_hopper
    sp_fn.argtypes, sp_fn.restype = fc.DH_SHAREP_ARGTYPES, ctypes.c_int
    for T, V, d in ((1000, 50257, 768), (257, 1000, 96)):
        h, w, lab, g = _fce_inputs(cuda, T, V, d, torch.bfloat16, 10)
        _, lse = fc.fused_ce_fwd(h, w, lab)
        want = fc.fused_ce_bwd_dh(h, w, lab, lse, g)
        _, want_dl = fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g)
        args = (h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                g.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        out, out_sp = torch.empty_like(h), torch.empty_like(h)
        dl = fc._dl_rows(T, V, h.device)
        assert dh_fn(1, *args, out.data_ptr(), T, V, d, stream) == 0
        assert sp_fn(1, *args, out_sp.data_ptr(), dl.data_ptr(),
                     dl.stride(0), T, V, d, stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), (T, V, d)
        assert torch.equal(out_sp, want), (T, V, d)
        assert torch.equal(dl[:, :V], want_dl), (T, V, d)


# T, V, d of the wgmma/TMA forward: ragged T and V at GPT-2's width (the
# build with every 64-column box of d live), d = 712 (the same build, its
# last box part zeros) and small d (the build that loads and multiplies
# only the boxes that hold d: 704 leaves the twelfth out)
FCE_FWD_CASES = {
    "vocab50257": (1000, 50257, 768),
    "v1000": (257, 1000, 768),
    "one_tile_and_a_row": (65, 129, 768),
    "d712": (200, 700, 712),
    "d704": (200, 700, 704),
    "d64": (300, 500, 64),
    "d136": (130, 333, 136),
}


@pytest.mark.parametrize("case", list(FCE_FWD_CASES))
def test_fused_ce_fwd_wgmma_matches_plain(cuda, case):
    """The wgmma/TMA forward: nll and lse against the plain forward within
    2e-6 of max-abs, rows whose label picks nothing with their nll equal
    to their lse, two launches bit-identical; at the split count the C
    side picks and at a forced count that leaves a split with no column
    (its parts -inf, 0, 0, which the combine ignores)."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    T, V, d = FCE_FWD_CASES[case]
    h, w, lab, _ = _fce_inputs(cuda, T, V, d, torch.bfloat16, 13)
    fc.reset_launches()
    runs = [fc.fused_ce_fwd(h, w, lab) for _ in range(2)]
    tiles = -(-V // 128)
    forced = fc._launch_fwd(h, w, lab, nsplit=tiles + 1)
    torch.cuda.synchronize()
    assert (fc.fwd_launches, fc.fwd_hopper_launches) == (3, 3)
    (nll, lse), again = runs
    assert torch.equal(nll, again[0]) and torch.equal(lse, again[1])
    rnll, rlse = fc.fused_ce_fwd_ref(h, w, lab)
    ftol = FCE_TOL[torch.bfloat16][0]
    for a, b in ((nll, rnll), (lse, rlse), (forced[0], rnll),
                 (forced[1], rlse)):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= ftol, _rel(a, b)
    none = (lab < 0) | (lab >= V)
    assert torch.equal(nll[none], lse[none])


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_fused_ce_fwd_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma forward built with its test hook FUSED_CE_FWD_STALL_WG,
    which sleeps one consumer warpgroup on every vocab tile so the other
    runs ahead through the ring: the producer must still wait for each
    box's reader before reusing its stage, so nll and lse equal the plain
    build's bit for bit."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as fc
    lib = _build.load("fused_ce", (f"-DFUSED_CE_FWD_STALL_WG={stalled}",))
    fn = lib.fused_ce_forward_hopper
    fn.argtypes, fn.restype = fc.FWD_ARGTYPES, ctypes.c_int
    splits = fc._kernel_fn("fused_ce_forward_hopper_splits",
                           fc.SPLITS_ARGTYPES)
    for T, V, d in ((1000, 50257, 768), (257, 1000, 96)):
        h, w, lab, _ = _fce_inputs(cuda, T, V, d, torch.bfloat16, 10)
        want = fc.fused_ce_fwd(h, w, lab)
        ns = splits(1, T, V, h.device.index)
        parts = torch.empty(3, ns, T, dtype=torch.float32, device=cuda)
        rc = fn(1, h.data_ptr(), w.data_ptr(), lab.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(),
                T, V, d, ns, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, (T, V, d)
        got = fc._combine(*parts)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), (T, V, d)
        assert torch.equal(got[1], want[1]), (T, V, d)


def test_tiny_fused_ce_training_step_with_the_kernels_equals_the_plain_step(
        cuda):
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 128, (3, 2, 40))
    labels = np.roll(ids, -1, axis=-1)
    labels[:, :, -1] = -100
    runs = {}
    for plain in (False, True):
        m = GPTForCausalLM(gpt2_tiny(dropout=0.0, bf16_residual=False,
                                     fused_ce=True), device=cuda, seed=3)
        step = TrainStep(m, lambda m_, i, y: m_.loss(i, y), AdamW(1e-3),
                         device=cuda)
        fc.reset_launches()
        with fc.use_plain() if plain else contextlib.nullcontext():
            _, grads, _ = step.grad_step(ids[0], labels[0])
            losses = step.multi_step(ids, labels)
        launches = (fc.fwd_launches, fc.dh_launches, fc.dw_launches)
        assert launches == ((0, 0, 0) if plain else (4, 4, 4))
        runs[plain] = (losses.cpu(), {n: p.detach().cpu()
                                      for n, p in m.named_parameters()},
                       [g_.cpu() for g_ in grads])
    torch.testing.assert_close(runs[False][0], runs[True][0], rtol=1e-5,
                               atol=1e-5)
    for name, a, b in zip(step._param_names, runs[False][2], runs[True][2]):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    # Adam normalises each element's gradient: an element whose gradient
    # is as small as the rounding noise between the runs may step the
    # other way, by up to 2 lr a step. Every element within that; all but
    # max(8, 1e-4 numel) of each tensor within rtol 1e-4 / atol 1e-5.
    # The key bias's exact gradient is zero (softmax ignores a constant per
    # query), so it is all noise and only held to the 2 lr bound.
    H = 64
    for name, a in runs[False][1].items():
        b = runs[True][1][name]
        d = (a - b).abs()
        assert float(d.max()) <= 2 * 3 * 1e-3, name
        if name.endswith("attn.qkv.bias"):
            d, b = torch.cat([d[:H], d[2 * H:]]), torch.cat([b[:H],
                                                             b[2 * H:]])
        off = int((d > 1e-5 + 1e-4 * b.abs()).sum())
        assert off <= max(8, 1e-4 * b.numel()), (name, off, float(d.max()))


def _bf16_steps(a, b):
    """How many bf16 rounding steps apart each pair of bf16 elements
    lies (the bit patterns ordered as the values are)."""
    def key(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FCE_CASES))
def test_fused_ce_sharep_kernels_match_plain(cuda, case, dtype):
    """The shared-dl pair against its plain versions: dh bit-identical to
    the recomputing dh kernel's (the same tile feeds it), dl within one
    bf16 step of the plain bf16 dl and zero in the columns the buffer
    pads V to, dw within the dw limit of the plain dw of the same dl,
    and the pair's dw apart from the plain pair's by no more than the dl
    steps move it."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    T, V, d = FCE_CASES[case]
    h, w, lab, g = _fce_inputs(cuda, T, V, d, dtype, 1)
    _, lse = fc.fused_ce_fwd(h, w, lab)
    fc.reset_launches()
    dh, dl = fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g)
    dw = fc.fused_ce_bwd_dw_sharep(h, dl)
    torch.cuda.synchronize()
    assert (fc.dh_sharep_launches, fc.dw_sharep_launches,
            fc.dh_launches, fc.dw_launches) == (1, 1, 0, 0)
    # bf16 with d a multiple of 8 takes the wgmma/TMA dh_sharep and
    # dw_sharep
    assert fc.dw_sharep_hopper_launches == (dtype == torch.bfloat16
                                            and d % 8 == 0)
    assert fc.dh_sharep_hopper_launches == fc.dw_sharep_hopper_launches
    assert dl.dtype == torch.bfloat16 and dl.shape == (T, V)
    assert dl.stride(0) == -(-V // 8) * 8
    rdh, rdl = fc.fused_ce_bwd_dh_sharep_ref(h, w, lab, lse, g)
    rdw = fc.fused_ce_bwd_dw_sharep_ref(h, rdl)
    assert torch.equal(dh, fc.fused_ce_bwd_dh(h, w, lab, lse, g))
    assert int(_bf16_steps(dl, rdl).max()) <= 1
    tail = torch.as_strided(dl, (T, dl.stride(0) - V), (dl.stride(0), 1), V)
    assert not tail.any()
    assert not dl[::3].any()            # g = 0 rows: a zero dl row
    _, gtol = FCE_TOL[dtype]
    for name, a, b in (("dh", dh, rdh),
                       ("dw", dw, fc.fused_ce_bwd_dw_sharep_ref(h, dl))):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= gtol, (name, _rel(a, b))
    # the pair against the plain pair: apart by what the dl steps move
    moved = (dl.float() - rdl.float()).abs().t() @ h.float().abs()
    assert bool(((dw.float() - rdw.float()).abs()
                 <= moved + gtol * rdw.float().abs().max()).all())
    # a contiguous dl (V not a multiple of 8: copied into aligned rows)
    assert torch.equal(fc.fused_ce_bwd_dw_sharep(h, dl.contiguous()), dw)


def test_fused_ce_sharep_pair_is_bit_identical_across_launches(cuda):
    from paddle_tpu_torch.kernels import fused_ce as fc
    h, w, lab, g = _fce_inputs(cuda, 700, 3001, 64, torch.bfloat16, 5)
    _, lse = fc.fused_ce_fwd(h, w, lab)
    runs = []
    for _ in range(2):
        dh, dl = fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g)
        runs.append((dh, dl, fc.fused_ce_bwd_dw_sharep(h, dl)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_tiny_fused_ce_sharep_step_with_the_kernels_equals_the_plain_step(
        cuda):
    """``_SHARE_P`` set: the training step launches the pair and not the
    recomputing dh/dw kernels, and its grads and losses match the same
    step through the plain pair."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 128, (3, 2, 40))
    labels = np.roll(ids, -1, axis=-1)
    labels[:, :, -1] = -100
    runs = {}
    prev, fc._SHARE_P = fc._SHARE_P, True
    try:
        for plain in (False, True):
            m = GPTForCausalLM(gpt2_tiny(dropout=0.0, bf16_residual=False,
                                         fused_ce=True), device=cuda, seed=3)
            step = TrainStep(m, lambda m_, i, y: m_.loss(i, y), AdamW(1e-3),
                             device=cuda)
            fc.reset_launches()
            with fc.use_plain() if plain else contextlib.nullcontext():
                _, grads, _ = step.grad_step(ids[0], labels[0])
                losses = step.multi_step(ids, labels)
            launches = (fc.fwd_launches, fc.dh_launches, fc.dw_launches,
                        fc.dh_sharep_launches, fc.dw_sharep_launches)
            assert launches == ((0,) * 5 if plain else (4, 0, 0, 4, 4))
            runs[plain] = (losses.cpu(), [g_.cpu() for g_ in grads])
    finally:
        fc._SHARE_P = prev
    torch.testing.assert_close(runs[False][0], runs[True][0], rtol=1e-5,
                               atol=1e-5)
    for name, a, b in zip(step._param_names, runs[False][1], runs[True][1]):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


def test_fused_ce_wrapper_raises_on_cuda_without_the_library(cuda, tmp_path,
                                                             monkeypatch):
    """No fallback: with the library unbuildable a CUDA tensor raises."""
    import torch.utils.cpp_extension as ext
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as fc
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(fc, "_fns", {})
    h, w, lab, _ = _fce_inputs(cuda, 16, 40, 32, torch.float32)
    with pytest.raises(RuntimeError, match="nvcc"):
        fc.fused_softmax_ce(h, w, lab)


# -- packed (segment-id) flash attention (kernels/packed_flash.py) ------------

PF_CASES = {            # B, H, L, D, causal, layout
    "pack4": (4, 3, 512, 64, False, "pack4"),
    "uneven": (3, 3, 512, 64, False, "uneven"),
    "uneven_causal": (3, 3, 512, 64, True, "uneven"),
    "ragged300": (3, 2, 300, 64, False, "uneven"),
    "d128": (2, 2, 320, 128, True, "pack4"),
    "d40": (2, 2, 200, 40, False, "uneven"),
}


def _pf_ids(dev, B, L, layout):
    """``pack4``: four equal segments a row; ``uneven``: rows in turn of
    three segments (100/300/112 of 512), one segment, and one id in two
    places (not contiguous)."""
    seg = np.zeros((B, L), np.int32)
    a, b = L * 100 // 512, L * 400 // 512
    for r in range(B):
        if layout == "pack4":
            seg[r] = np.repeat(np.arange(4), -(-L // 4))[:L]
        elif r % 3 == 0:
            seg[r, :a], seg[r, a:b], seg[r, b:] = 5, 7, 9
        elif r % 3 == 1:
            seg[r] = 3
        else:
            seg[r, :a], seg[r, a:b], seg[r, b:] = 5, 7, 5
    return torch.tensor(seg, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(PF_CASES))
def test_packed_flash_kernels_match_plain(cuda, case, dtype):
    from paddle_tpu_torch.kernels import packed_flash as pf
    B, H, L, D, causal, layout = PF_CASES[case]
    q, k, v, do = _fa_inputs(cuda, B, H, L, L, D, dtype, seed=8)
    seg = _pf_ids(cuda, B, L, layout)
    pf.reset_launches()
    out, lse = pf.packed_flash_fwd(q, k, v, seg, causal)
    delta = pf.attention_delta(out, do)
    dq = pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, delta, causal)
    dk, dv = pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (pf.fwd_launches, pf.dq_launches, pf.dkv_launches) == (1, 1, 1)
    rout, rlse = pf.packed_flash_fwd_ref(q, k, v, seg, causal)
    rdq = pf.packed_flash_bwd_dq_ref(q, k, v, seg, do, lse, delta, causal)
    rdk, rdv = pf.packed_flash_bwd_dkv_ref(q, k, v, seg, do, lse, delta,
                                           causal)
    ftol, gtol = FA_TOL[dtype]
    assert _rel(out, rout) <= ftol and _rel(lse, rlse) <= ftol
    for name, a, b in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= gtol, (name, _rel(a, b))


def test_packed_flash_backward_is_bit_identical_across_launches(cuda):
    from paddle_tpu_torch.kernels import packed_flash as pf
    q, k, v, do = _fa_inputs(cuda, 3, 3, 512, 512, 64, torch.bfloat16, 9)
    seg = _pf_ids(cuda, 3, 512, "uneven")
    out, lse = pf.packed_flash_fwd(q, k, v, seg, True)
    delta = pf.attention_delta(out, do)
    runs = [(pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, delta, True),
             *pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta, True))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_tiny_bert_packed_step_with_the_kernels_equals_the_plain_step(cuda):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import packed_flash as pf
    from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                              bert_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.tools import bench_bert
    ids, y, seg, starts = bench_bert.make_data(8, 4, k=3, vocab=256, seq=32)
    mask = pf.SegmentIds(torch.tensor(seg, device=cuda),
                         start_positions=torch.tensor(starts, device=cuda))
    runs = {}
    for plain in (False, True):
        m = BertForSequenceClassification(bert_tiny(dropout=0.0),
                                          device=cuda, seed=3)
        step = TrainStep(m, bench_bert.make_loss_fn(mask, amp_level=None),
                         AdamW(1e-3), device=cuda)
        pf.reset_launches()
        fa.reset_launches()
        first = torch.tensor(ids[0], device=cuda)
        with pf.use_plain() if plain else contextlib.nullcontext():
            with torch.no_grad():
                packed = m(first, attention_mask=mask)
                unpacked = m(first.reshape(8, 32))
            losses = step.multi_step(ids, y)
        launches = (pf.fwd_launches, pf.dq_launches, pf.dkv_launches)
        assert launches == ((0, 0, 0) if plain else (8, 6, 6))
        assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == \
            (2, 0, 0)                      # the unpacked forward, 2 layers
        # the same examples packed four to a row and unpacked
        torch.testing.assert_close(packed.reshape(8, -1), unpacked,
                                   rtol=1e-5, atol=1e-5)
        runs[plain] = (losses.cpu(), {n: p.detach().cpu()
                                      for n, p in m.named_parameters()},
                       packed.cpu())
    torch.testing.assert_close(runs[False][0], runs[True][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(runs[False][2], runs[True][2], rtol=1e-5,
                               atol=1e-5)
    for name, a in runs[False][1].items():
        b = runs[True][1][name]
        if name.endswith("k_proj.bias"):
            # exact gradient zero: Adam steps rounding noise, 3 x 1e-3 at most
            torch.testing.assert_close(a, b, rtol=0, atol=2 * 3 * 1e-3)
            continue
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["bert", "uneven", "uneven_causal", "L300",
                                  "L2048", "L4096", "d128"])
def test_packed_forward_designs_at_the_smoke_shapes(cuda, case, dtype):
    """chip_smoke.PACKED_CASES: bfloat16 on the wgmma/TMA forward, float32
    on the CUDA-core one, within the forward limits, and two launches
    bit-identical."""
    import chip_smoke
    from paddle_tpu_torch.kernels import packed_flash as pf
    B, H, L, D, causal, layout = chip_smoke.PACKED_CASES[case]
    q, k, v, _ = _fa_inputs(cuda, B, H, L, L, D, dtype, 14)
    seg = chip_smoke.packed_ids(B, L, layout)
    pf.reset_launches()
    runs = [pf.packed_flash_fwd(q, k, v, seg, causal) for _ in range(2)]
    torch.cuda.synchronize()
    hopper = dtype == torch.bfloat16
    assert (pf.fwd_launches, pf.fwd_hopper_launches) == (2, 2 * hopper)
    assert pf.hopper_fwd(q, k, v, seg) is hopper
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    rout, rlse = pf.packed_flash_fwd_ref(q, k, v, seg, causal)
    ftol = FA_TOL[dtype][0]
    assert _rel(runs[0][0], rout) <= ftol and _rel(runs[0][1], rlse) <= ftol


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_packed_forward_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma packed forward built with its test hook
    PACKED_FWD_STALL_WG, which sleeps one consumer warpgroup on every tile
    it computes: the other runs ahead (and releases the tiles it skips at
    once), so the producer must reload no stage the lagging warpgroup
    still reads; the output equals the plain build's bit for bit."""
    import chip_smoke
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import packed_flash as pf
    lib = _build.load("packed_flash", (f"-DPACKED_FWD_STALL_WG={stalled}",))
    fn = lib.packed_flash_forward_hopper
    fn.argtypes, fn.restype = pf.FWD_ARGTYPES, ctypes.c_int
    for case in ("bert", "uneven", "uneven_causal", "L300", "d128"):
        B, H, L, D, causal, layout = chip_smoke.PACKED_CASES[case]
        B = min(B, 4)
        q, k, v, _ = _fa_inputs(cuda, B, H, L, L, D, torch.bfloat16, 15)
        seg = chip_smoke.packed_ids(B, L, layout)
        want = pf.packed_flash_fwd(q, k, v, seg, causal)
        out = torch.empty_like(q)
        lse = torch.empty(B * H, L, dtype=torch.float32, device=cuda)
        rc = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                out.data_ptr(), lse.data_ptr(),
                *pf._dims(q, pf._default_scale(q, None), causal))
        assert rc == 0, case
        torch.cuda.synchronize()
        assert torch.equal(out, want[0]) and torch.equal(lse, want[1]), case


def test_packed_flash_wrapper_raises_on_cuda_without_the_library(
        cuda, tmp_path, monkeypatch):
    """No fallback: with the library unbuildable a CUDA tensor raises."""
    import torch.utils.cpp_extension as ext
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import packed_flash as pf
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(pf, "_fns", {})
    q, k, v, _ = _fa_inputs(cuda, 1, 2, 64, 64, 64, torch.float32)
    with pytest.raises(RuntimeError, match="nvcc"):
        pf.packed_flash_attention(q, k, v, _pf_ids(cuda, 1, 64, "pack4"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["bert", "uneven", "uneven_causal", "L300",
                                  "L2048", "L4096", "d128"])
def test_packed_backward_designs_at_the_smoke_shapes(cuda, case, dtype):
    """chip_smoke.PACKED_CASES: bfloat16 at D = 64 on the wgmma/TMA dq and
    dk/dv, float32 and D = 128 on the CUDA-core ones (the counters say
    which), within the gradient limits of the plain versions, finite, and
    two launches bit-identical."""
    import chip_smoke
    from paddle_tpu_torch.kernels import packed_flash as pf
    B, H, L, D, causal, layout = chip_smoke.PACKED_CASES[case]
    q, k, v, do = _fa_inputs(cuda, B, H, L, L, D, dtype, 16)
    seg = chip_smoke.packed_ids(B, L, layout)
    out, lse = pf.packed_flash_fwd(q, k, v, seg, causal)
    delta = pf.attention_delta(out, do)
    pf.reset_launches()
    runs = [(pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, delta, causal),
             *pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    hopper = dtype == torch.bfloat16 and D == 64
    assert pf.hopper_bwd(q, k, v, do, seg) is hopper
    assert (pf.dq_launches, pf.dkv_launches) == (2, 2)
    assert (pf.dq_hopper_launches, pf.dkv_hopper_launches) == (
        2 * hopper, 2 * hopper)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    want = (pf.packed_flash_bwd_dq_ref(q, k, v, seg, do, lse, delta, causal),
            *pf.packed_flash_bwd_dkv_ref(q, k, v, seg, do, lse, delta,
                                         causal))
    gtol = FA_TOL[dtype][1]
    for name, a, b in zip(("dq", "dk", "dv"), runs[0], want):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= gtol, (name, _rel(a, b))


@pytest.mark.parametrize("stalled", [0, 1], ids=["wg0_lags", "wg1_lags"])
def test_packed_backward_holds_when_one_warpgroup_lags(cuda, stalled):
    """The wgmma packed dq and dk/dv built with their test hook
    PACKED_BWD_STALL_WG, which sleeps one consumer warpgroup on every tile
    it computes in both kernels: the other runs ahead (and releases the
    tiles it skips at once), so the producer must reload no stage the
    lagging warpgroup still reads; the gradients equal the plain build's
    bit for bit."""
    import chip_smoke
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import packed_flash as pf
    lib = _build.load("packed_flash", (f"-DPACKED_BWD_STALL_WG={stalled}",))
    fdq = lib.packed_flash_backward_dq_hopper
    fdkv = lib.packed_flash_backward_dkv_hopper
    fdq.argtypes, fdq.restype = pf.DQ_ARGTYPES, ctypes.c_int
    fdkv.argtypes, fdkv.restype = pf.DKV_ARGTYPES, ctypes.c_int
    for case in ("bert", "uneven", "uneven_causal", "L300", "L4096"):
        B, H, L, D, causal, layout = chip_smoke.PACKED_CASES[case]
        B = min(B, 4)
        q, k, v, do = _fa_inputs(cuda, B, H, L, L, D, torch.bfloat16, 17)
        seg = chip_smoke.packed_ids(B, L, layout)
        out, lse = pf.packed_flash_fwd(q, k, v, seg, causal)
        delta = pf.attention_delta(out, do)
        want = (pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, delta, causal),
                *pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta,
                                         causal))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        ptrs = [t.data_ptr() for t in (q, k, v, seg, do, lse, delta)]
        dims = pf._dims(q, pf._default_scale(q, None), causal)
        assert fdq(1, *ptrs, dq.data_ptr(), *dims) == 0, case
        assert fdkv(1, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims) == 0, case
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert torch.equal(a, b), (case, name)


# -- ResNet-50 training (bench.py): cuDNN/ATen on the card against the CPU --

@pytest.mark.parametrize("case", ["conv_s2_p3", "conv_same_s2_nhwc",
                                  "conv_groups_bias", "max_pool",
                                  "adaptive_avg_pool", "batch_norm_train",
                                  "batch_norm_nhwc", "batch_norm_bf16"])
def test_resnet_functional_ops_on_the_card_match_the_cpu(cuda, case):
    """Output, input gradients and running statistics on the card within
    1e-5 of max-abs of the CPU's (float32, TF32 off), or 1e-2 for the bf16
    batch norm (bf16 input, float32 weight, bias and statistics)."""
    from chip_smoke import max_rel
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator().manual_seed(len(case))
    x = torch.randn(4, 8, 15, 15, generator=g)
    w = torch.randn(8, 8, 7, 7, generator=g) * 0.1
    stats = [torch.zeros(8), torch.ones(8)]
    ops = {
        "conv_s2_p3": (lambda t, s: F.conv2d(t, w.to(t.device), None, 2, 3)),
        "conv_same_s2_nhwc": (lambda t, s: F.conv2d(
            t.permute(0, 2, 3, 1).contiguous(), w[:, :, :3, :3].to(t.device),
            None, 2, "SAME", data_format="NHWC")),
        "conv_groups_bias": (lambda t, s: F.conv2d(
            t, w[:, :4, :3, :3].to(t.device),
            torch.ones(8, device=t.device), 1, [1, 0, 2, 1], groups=2)),
        "max_pool": (lambda t, s: F.max_pool2d(t, 3, 2, 1)),
        "adaptive_avg_pool": (lambda t, s: F.adaptive_avg_pool2d(t, 4)),
        "batch_norm_train": (lambda t, s: F.batch_norm(
            t, *s, torch.full((8,), 1.5, device=t.device),
            torch.full((8,), 0.5, device=t.device), training=True)),
        "batch_norm_nhwc": (lambda t, s: F.batch_norm(
            t.permute(0, 2, 3, 1), *s, training=True, data_format="NHWC")),
        "batch_norm_bf16": (lambda t, s: F.batch_norm(
            t.to(torch.bfloat16), *s, torch.ones(8, device=t.device),
            torch.zeros(8, device=t.device), training=True)),
    }
    tol = 1e-2 if case.endswith("bf16") else 1e-5
    res = []
    for dev in (cuda, "cpu"):
        t = x.to(dev).requires_grad_()
        s = [v.to(dev) for v in stats]
        out = ops[case](t, s)
        # a random projection: sum(out^2) would give batch norm a dx that
        # cancels to rounding noise
        proj = torch.randn(out.shape, generator=torch.Generator()
                           .manual_seed(7)).to(dev)
        (out.float() * proj).sum().backward()
        res.append((out, t.grad, s))
    (out, dx, s), (wout, wdx, ws) = res
    assert out.dtype == wout.dtype and out.shape == wout.shape
    assert max_rel(out, wout) <= tol
    assert max_rel(dx, wdx) <= tol
    for a, b in zip(s, ws):
        assert a.dtype == torch.float32
        assert max_rel(a, b) <= 1e-5


def test_resnet18_multi_step_on_the_card_matches_the_cpu(cuda):
    """ResNet-18 (BasicBlock), batch 4 of 64 x 64, three Momentum steps at
    lr 1e-4: losses rtol 1e-5, parameter updates within 5e-2 in relative
    L2 and buffers within 1e-4 of max-abs (the CPU test's limits for
    ResNet-18; a ReLU gate that flips under rounding in steps 2-3 moves
    an update by a few percent: 2.0e-2 read)."""
    from chip_smoke import max_rel, update_l2
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.vision.models import (load_reference_state,
                                                reference_state, resnet18)
    cpu = resnet18(num_classes=10, device="cpu", seed=0)
    gpu = resnet18(num_classes=10, device=cuda, seed=1)
    load_reference_state(gpu, *reference_state(cpu))
    p0 = reference_state(cpu)[0]
    g = torch.Generator().manual_seed(1)
    xs, ys = torch.rand(3, 4, 3, 64, 64, generator=g), \
        torch.randint(0, 10, (3, 4), generator=g)
    losses = []
    for m, dev in ((gpu, cuda), (cpu, "cpu")):
        step = TrainStep(m, lambda mm, x, y: cross_entropy(mm(x), y),
                         Momentum(learning_rate=1e-4, momentum=0.9),
                         device=dev)
        losses.append(step.multi_step(xs.to(dev), ys.to(dev)).cpu())
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=0)
    (gp, gb), (cp, cb) = reference_state(gpu), reference_state(cpu)
    for n in cp:
        d = update_l2(gp[n], cp[n], p0[n])
        assert d <= 5e-2, (n, d)
    for n in cb:
        assert max_rel(gb[n], cb[n]) <= 1e-4, n


def test_resnet50_with_no_device_lands_on_the_card(cuda):
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.vision.models import resnet50
    m = resnet50()
    assert {p.device.type for p in m.parameters()} == {"cuda"}
    assert {b.device.type for b in m.buffers()} == {"cuda"}
    step = TrainStep(m, lambda mm, x, y: 0, Momentum())
    assert step.device.type == "cuda"
