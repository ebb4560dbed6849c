"""The port's collectives and rank launcher
(paddle_tpu_torch/distributed/{env,collective,spawn}.py) on two ``gloo``
ranks on the CPU, against numpy: each collective of the reference's API
(``paddle_tpu/distributed/collective.py``), the model-parallel helpers,
a subgroup, the environment queries; world size 1 gives identities with
no process group; a rank's exception reaches the parent naming the rank;
the backend rule (``spawn.choose_backend``) and a forced ``nccl`` that
cannot start. The rank function lives in tests/tp_ranks.py (no JAX).
Exact comparisons: the collectives move and add small integers."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed.spawn import choose_backend, spawn

import tp_ranks


@pytest.fixture(scope="module")
def two():
    return spawn(tp_ranks.collectives, nprocs=2, device="cpu")


def test_collectives_match_numpy(two):
    base = [np.arange(4, dtype=np.float32) + 10 * r for r in range(2)]
    for r, out in enumerate(two):
        assert (out["rank"], out["world"], out["initialized"],
                out["backend"]) == (r, 2, True, "gloo")
        np.testing.assert_array_equal(out["all_reduce"], base[0] + base[1])
        np.testing.assert_array_equal(out["all_reduce_max"], base[1])
        np.testing.assert_array_equal(out["all_reduce_avg"],
                                      (base[0] + base[1]) / 2)
        for q in range(2):
            np.testing.assert_array_equal(out["all_gather"][q], base[q])
            np.testing.assert_array_equal(out["all_gather_int8"][q],
                                          base[q].astype(np.int8))
        assert out["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
        np.testing.assert_array_equal(out["broadcast"], base[1])
        # reduce_scatter: rank r gets sum over ranks of their list[r]
        np.testing.assert_array_equal(
            out["reduce_scatter"], base[0][:2] + base[1][:2] + 2 * r)
        np.testing.assert_array_equal(out["scatter"], np.full(3, r))
        for q in range(2):   # rank q's entry r, sent to r
            np.testing.assert_array_equal(out["alltoall"][q],
                                          np.full(2, 10 * q + r))
        np.testing.assert_array_equal(out["mp_allreduce"],
                                      base[0] + base[1])
        np.testing.assert_array_equal(out["c_identity"], base[r])
        np.testing.assert_array_equal(out["c_concat"],
                                      np.concatenate(base))
        np.testing.assert_array_equal(out["c_split"],
                                      np.arange(4)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["sub_all_reduce"],
                                      base[0] + base[1])
    np.testing.assert_array_equal(two[0]["reduce"], base[0] + base[1])
    np.testing.assert_array_equal(two[1]["recv"], base[0])


def test_world_size_one_is_the_identity():
    assert not env.is_initialized()
    assert (env.get_rank(), env.get_world_size()) == (0, 1)
    env.init_parallel_env()                 # one rank: nothing to join
    assert not env.is_initialized()
    t = torch.arange(3.0)
    assert C.all_reduce(t) is t and torch.equal(t, torch.arange(3.0))
    assert torch.equal(C.all_gather(None, t)[0], t)
    assert C.broadcast(t) is t and C.reduce(t) is t
    out = torch.zeros(3)
    C.reduce_scatter(out, [t])
    assert torch.equal(out, t)
    objs = []
    assert C.all_gather_object(objs, 5) == [5]
    assert C._c_concat(t) is t and C._c_split(t) is t
    assert C.get_backend() == "none"
    C.barrier()
    assert env.ParallelEnv().world_size == 1


def test_a_rank_exception_names_the_rank():
    with pytest.raises(RuntimeError, match="rank 1") as e:
        spawn(tp_ranks.raise_on, (1,), nprocs=2, device="cpu", grace=5)
    assert "boom on rank 1" in str(e.value)


def test_backend_rule(monkeypatch):
    assert choose_backend("cpu", 2) == ("gloo", [torch.device("cpu")] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend("cuda", 2) == (
        "nccl", [torch.device("cuda", 0), torch.device("cuda", 1)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend("cuda", 2) == (
        "gloo", [torch.device("cuda", 0)] * 2)


def test_no_fallback():
    """Without CUDA the default device raises; a forced nccl that cannot
    start raises in its ranks (it never becomes gloo)."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(tp_ranks.raise_on, (9,), nprocs=2)
    with pytest.raises(RuntimeError, match="rank 0"):
        spawn(tp_ranks.raise_on, (9,), nprocs=2, device="cpu",
              backend="nccl", grace=5)
