"""Ragged paged attention of the PyTorch port
(paddle_tpu_torch/kernels/paged_attention.py) against the reference's
numpy oracle (a copy of tests/test_ragged_kernel.py ``_oracle`` on its
``_mixed_case``) and against the JAX engine's gather path.

On the CPU the dispatcher runs the plain PyTorch version and launches
nothing; the CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (skipped without a card) and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as pa

# tiny shapes: a few threads are plenty, and the suite runs several
# workers at once beside timing-sensitive tests
torch.set_num_threads(2)


def _mixed_case(rng, NP=17, PS=8, NH=4, HD=16, MP=4, QB=8):
    """Four slots covering every row kind in ONE call: decode (q_len
    1), a full prefill chunk (q_len QB), a k+1 verify row (q_len 4), and
    an idle slot (kv_len 0)."""
    q = rng.randn(4, QB, NH, HD).astype(np.float32)
    kf = rng.randn(NP, PS, NH, HD).astype(np.float32)
    vf = rng.randn(NP, PS, NH, HD).astype(np.float32)
    bt = rng.permutation(np.arange(1, NP))[:4 * MP].reshape(4, MP) \
        .astype(np.int32)
    kv_lens = np.array([27, QB, 12, 0], np.int32)
    q_lens = np.array([1, QB, 4, 1], np.int32)
    return q, kf, vf, bt, kv_lens, q_lens


def _oracle(q, kd, vd, bt, kv_lens, q_lens):
    """Row j of slot s sits at position kv_lens[s]-q_lens[s]+j and
    attends causally through itself; idle slots emit zeros."""
    S, QB, NH, HD = q.shape
    PS = kd.shape[1]
    T = bt.shape[1] * PS
    scale = 1.0 / np.sqrt(HD)
    out = np.zeros((S, QB, NH, HD), np.float32)
    for s in range(S):
        n, qn = int(kv_lens[s]), int(q_lens[s])
        if n == 0:
            continue
        k = kd[bt[s]].reshape(T, NH, HD)
        v = vd[bt[s]].reshape(T, NH, HD)
        for j in range(qn):
            lim = min(n, n - qn + 1 + j)
            sc = np.einsum("hd,thd->ht", q[s, j], k[:lim]) * scale
            p = np.exp(sc - sc.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            out[s, j] = np.einsum("ht,thd->hd", p, v[:lim])
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _live(q_lens, QB):
    return (np.arange(QB)[None, :] < np.asarray(q_lens)[:, None])[
        :, :, None, None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_numpy_oracle(seed):
    case = _mixed_case(np.random.RandomState(seed))
    out = pa.ragged_paged_attention_ref(*_t(*case)).numpy()
    ref = _oracle(*case)
    live = _live(case[5], case[0].shape[1])
    np.testing.assert_allclose(np.where(live, out, 0.0),
                               np.where(live, ref, 0.0),
                               rtol=2e-5, atol=2e-5)
    assert np.all(out[3] == 0.0)          # idle slot: zeros
    assert np.all(np.isfinite(out))       # padding rows stay finite


def test_dispatcher_runs_plain_on_cpu_and_launches_nothing():
    case = _t(*_mixed_case(np.random.RandomState(3)))
    before = pa.launches
    out = pa.ragged_paged_attention(*case)
    assert pa.launches == before
    torch.testing.assert_close(out, pa.ragged_paged_attention_ref(*case),
                               rtol=0, atol=0)


def test_padding_rows_attend_the_full_extent():
    q, kf, vf, bt, kv_lens, q_lens = _mixed_case(np.random.RandomState(4))
    out = pa.ragged_paged_attention_ref(
        *_t(q, kf, vf, bt, kv_lens, q_lens)).numpy()
    # slot 2 (kv 12, q_len 4): padding row 6 == a live last row over 12
    full = _oracle(q[2:3, 6:7], kf, vf, bt[2:3], kv_lens[2:3],
                   np.ones(1, np.int32))
    np.testing.assert_allclose(out[2, 6], full[0, 0], rtol=2e-5, atol=2e-5)


def test_decode_entry_is_the_q_len_one_row():
    rng = np.random.RandomState(5)
    q, kf, vf, bt, kv_lens, _ = _mixed_case(rng, QB=1)
    qt, kt, vt, btt, kl = _t(q[:, 0], kf, vf, bt, kv_lens)
    out = pa.paged_decode_attention(qt, kt, vt, btt, kl).numpy()
    ref = _oracle(q, kf, vf, bt, kv_lens, np.ones(4, np.int32))[:, 0]
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_bf16_pool_plain_version_within_bf16_rounding():
    case = _mixed_case(np.random.RandomState(6))
    q, k, v, bt, kl, ql = _t(*case)
    out = pa.ragged_paged_attention_ref(q, k.bfloat16(), v.bfloat16(), bt,
                                        kl, ql)
    assert out.dtype == torch.float32
    live = _live(case[5], case[0].shape[1])
    ref = _oracle(*case)
    np.testing.assert_allclose(np.where(live, out.numpy(), 0.0),
                               np.where(live, ref, 0.0), atol=2e-2)


def test_plain_matches_jax_engine_gather_path():
    """The reference engine's off-TPU decode attention
    (inference/serving.py ``ragged_attn_one`` under ``jax.vmap``),
    rebuilt from its jnp ops: gather the slot's pages, mask positions
    >= n_valid to -1e30, softmax."""
    import jax
    rng = np.random.RandomState(7)
    q, kf, vf, bt, kv_lens, _ = _mixed_case(rng, QB=1)
    kv_lens = np.array([27, 5, 12, 1], np.int32)
    S, _, NH, HD = q.shape
    T = bt.shape[1] * kf.shape[1]

    def one(qs, bts, n):
        k = jnp.asarray(kf)[bts].reshape(T, NH, HD)
        v = jnp.asarray(vf)[bts].reshape(T, NH, HD)
        s = jnp.einsum("hd,thd->ht", qs, k) * (1.0 / HD ** 0.5)
        s = jnp.where(jnp.arange(T)[None, :] < n, s, -1e30)
        return jnp.einsum("ht,thd->hd", jax.nn.softmax(s, axis=-1), v)

    ref = np.asarray(jax.vmap(one)(jnp.asarray(q[:, 0]), jnp.asarray(bt),
                                   jnp.asarray(kv_lens)))
    out = pa.paged_decode_attention(*_t(q[:, 0], kf, vf, bt,
                                        kv_lens)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["bt_int64", "pool_mismatch", "q_f16",
                                 "noncontig", "lens_shape"])
def test_wrapper_checks_reject_bad_inputs(bad):
    q, k, v, bt, kl, ql = _t(*_mixed_case(np.random.RandomState(8)))
    if bad == "bt_int64":
        bt = bt.long()
    elif bad == "pool_mismatch":
        v = v[:, :, :2].contiguous()
    elif bad == "q_f16":
        q = q.half()
    elif bad == "noncontig":
        q = q.transpose(1, 2)
    elif bad == "lens_shape":
        kl = kl[:3]
    with pytest.raises((TypeError, ValueError)):
        pa._check(q, k, v, bt, kl, ql)
