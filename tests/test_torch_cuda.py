"""Tests of the PyTorch port that need a CUDA device: the hand-written
ragged paged-attention kernel against its plain PyTorch version, and
the serving engine on the card against the same engine on the CPU.

Every test skips without a card (the kernel has no CPU mode). This file
imports no JAX, so it also runs on the GPU machine, which has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py imports JAX for the reference's
tests)."""
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
