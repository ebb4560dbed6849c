"""``paddle_tpu_torch.io`` and ``paddle_tpu_torch.metric`` against
``paddle_tpu.io`` and ``paddle_tpu.metric`` on the CPU.

- Datasets, samplers and the loader: after the same ``np.random.seed``
  both packages draw the same sampler orders (random, with replacement,
  weighted, ``random_split``) and the loader gives the same batches in
  the same order (shuffled, ``drop_last``, dict samples, a custom
  collate, ``IterableDataset`` and ``ChainDataset``), element for
  element (the batches are copies of the same numpy rows).
- Metrics: ``Accuracy`` (top-1 and top-(1, 3), one-hot labels),
  ``Precision``, ``Recall``, ``Auc`` and ``accuracy`` over the same
  predictions give the same values (host numpy on both sides, exact).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import metric as pmetric


def _arrays(b):
    """A batch (tensor, list, dict) of either package as numpy."""
    if isinstance(b, dict):
        return {k: _arrays(v) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        return [_arrays(v) for v in b]
    if isinstance(b, torch.Tensor):
        return b.numpy()
    return np.asarray(b._array) if hasattr(b, "_array") else np.asarray(b)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


class _Pairs:
    def __init__(self, n=23):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 3).astype(np.float32)
        self.y = rng.randint(0, 5, n).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _ds(pkg):
    base = _Pairs()

    class DS(pkg.Dataset):
        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            return base[i]
    return DS()


def _dict_ds(pkg):
    base = _Pairs(10)

    class DS(pkg.Dataset):
        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            return {"x": base.x[i], "y": base.y[i]}
    return DS()


def _iter_ds(pkg, n, off=0):
    class DS(pkg.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield np.full(2, i + off, np.float32)
    return DS()


def _loaders(pkg):
    ds = _ds(pkg)
    t = pkg.TensorDataset([np.arange(30).reshape(10, 3).astype(np.float32),
                           np.arange(10)])
    return {
        "shuffled": pkg.DataLoader(ds, batch_size=4, shuffle=True),
        "drop_last": pkg.DataLoader(ds, batch_size=5, shuffle=True,
                                    drop_last=True),
        "tensor_fast_path": pkg.DataLoader(t, batch_size=3, shuffle=True),
        "dicts": pkg.DataLoader(_dict_ds(pkg), batch_size=4),
        "collate": pkg.DataLoader(ds, batch_size=6, collate_fn=lambda b: [
            np.stack([s[0] for s in b]).sum(0)]),
        "iterable": pkg.DataLoader(_iter_ds(pkg, 7), batch_size=3),
        "chain": pkg.DataLoader(pkg.ChainDataset(
            [_iter_ds(pkg, 3), _iter_ds(pkg, 4, 10)]), batch_size=2,
            drop_last=True),
        "compose": pkg.DataLoader(pkg.ComposeDataset(
            [_ds(pkg), _ds(pkg)]), batch_size=8),
        "concat": pkg.DataLoader(pkg.ConcatDataset(
            [_ds(pkg), _ds(pkg)]), batch_size=9, shuffle=True),
        "no_batch": pkg.DataLoader(_ds(pkg), batch_size=None),
    }


@pytest.mark.parametrize("name", list(_loaders(pio)))
def test_loaders_give_the_same_batches_in_the_same_order(name):
    runs = []
    for pkg in (jio, pio):
        np.random.seed(42)
        loader = _loaders(pkg)[name]
        runs.append([_arrays(b) for epoch in range(2) for b in loader])
    assert len(runs[0]) == len(runs[1]) > 0
    for a, b in zip(*runs):
        _same(b, a)
    if name != "iterable" and name != "chain":
        np.random.seed(0)
        assert len(_loaders(pio)[name]) == len(_loaders(jio)[name])


def test_samplers_and_random_split_draw_the_same_indices():
    out = []
    for pkg in (jio, pio):
        np.random.seed(7)
        ds = _ds(pkg)
        r = []
        r.append(list(pkg.RandomSampler(ds)))
        r.append(list(pkg.RandomSampler(ds, replacement=True,
                                        num_samples=9)))
        r.append(list(pkg.WeightedRandomSampler([0.1, 0.5, 0.2, 0.2], 12)))
        r.append(list(pkg.SequenceSampler(ds)))
        r.append(list(pkg.BatchSampler(ds, shuffle=True, batch_size=5)))
        r.append([s.indices for s in pkg.random_split(ds, [10, 13])])
        sub = pkg.Subset(ds, [3, 1, 4])
        r.append([int(sub[i][1]) for i in range(len(sub))])
        out.append(r)
    assert out[0] == out[1]


def test_unported_loader_parts_raise():
    ds = _ds(pio)
    with pytest.raises(NotImplementedError):
        pio.DataLoader(ds, num_workers=2)
    with pytest.raises(NotImplementedError):
        pio.DistributedBatchSampler(ds, batch_size=4)
    assert pio.get_worker_info() is None


def _preds(seed=0, n=40, k=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, k).astype(np.float32), rng.randint(0, k, n),
            rng.rand(n).astype(np.float32), rng.randint(0, 2, n))


def test_metrics_match_the_reference():
    logits, labels, probs, binary = _preds()
    for topk in ((1,), (1, 3)):
        j, p = jmetric.Accuracy(topk=topk), pmetric.Accuracy(topk=topk)
        assert p.name() == j.name()
        for s in (slice(0, 17), slice(17, 40)):
            jc = j.compute(paddle.to_tensor(logits[s]),
                           paddle.to_tensor(labels[s]))
            pc = p.compute(torch.from_numpy(logits[s]),
                           torch.from_numpy(labels[s]))
            np.testing.assert_array_equal(pc, jc)
            np.testing.assert_array_equal(p.update(pc), j.update(jc))
        assert p.accumulate() == j.accumulate()
        p.reset()
        assert p.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])
    onehot = np.eye(5, dtype=np.float32)[labels]
    assert pmetric.Accuracy().compute(logits, onehot).tolist() == \
        jmetric.Accuracy().compute(logits, onehot).tolist()
    for cls in ("Precision", "Recall", "Auc"):
        j, p = getattr(jmetric, cls)(), getattr(pmetric, cls)()
        two = np.stack([1 - probs, probs], 1)
        arg = two if cls == "Auc" else probs
        j.update(arg, binary)
        p.update(torch.from_numpy(arg), torch.from_numpy(binary))
        assert p.accumulate() == j.accumulate(), cls
        assert p.name() == j.name()
    for k in (1, 2):
        got = pmetric.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(labels), k=k)
        want = jmetric.accuracy(paddle.to_tensor(logits),
                                paddle.to_tensor(labels), k=k)
        assert got.dtype == torch.float32
        assert float(got) == float(want._array)
