"""Data loading — port of ``paddle_tpu/io/__init__.py`` (``:22-514``):
``Dataset``, ``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``ConcatDataset``, ``Subset``, ``random_split``, the
samplers, ``BatchSampler``, ``default_collate_fn`` and ``DataLoader``
with ``num_workers=0``.

The samplers draw from numpy's global generator as the reference's do
(``np.random.permutation`` / ``randint`` / ``choice``), so after the same
``np.random.seed`` the two packages give the same batches in the same
order. A batch is collated to numpy on the host and handed out as CPU
torch tensors (``return_list`` lists of them, dicts kept); the consumer
places it (``hapi.Model`` and ``TrainStep`` move batches to their
device). Not ported (ROADMAP A9): worker processes or threads
(``num_workers > 0``: the reference's shared-memory workers,
``:515-561``) and ``DistributedBatchSampler``; both raise
``NotImplementedError``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "DataLoader", "get_worker_info"]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Rows of equal-length arrays or tensors, as numpy."""

    def __init__(self, tensors):
        self.tensors = [_np(t) for t in tensors]
        assert all(t.shape[0] == self.tensors[0].shape[0]
                   for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __getitems__(self, idxs):
        """Vectorized batch fetch (the DataLoader's fast path)."""
        sel = np.asarray(idxs)
        return tuple(t[sel] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        d_i = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if d_i == 0 else self.cum[d_i - 1]
        return self.datasets[d_i][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("lengths sum mismatch")
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln].tolist()))
        off += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement,
                                     p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else \
                SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharding of the reference (``:178-227``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistributedBatchSampler is not ported to paddle_tpu_torch yet "
            "(it comes with the multi-GPU slice, ROADMAP A8)")


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic, int, float)):
        return np.stack([np.asarray(b) for b in batch])
    if isinstance(sample, torch.Tensor):
        return np.stack([_np(b) for b in batch])
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(s)) for s in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return np.asarray(batch)


def _to_tensors(batch):
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch))
    if isinstance(batch, (list, tuple)):
        return [_to_tensors(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _to_tensors(v) for k, v in batch.items()}
    return _to_tensors(np.asarray(batch))


class DataLoader:
    """``paddle.io.DataLoader`` with ``num_workers=0``: batches collated
    in the calling thread and handed out as CPU tensors."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers:
            raise NotImplementedError(
                "DataLoader(num_workers > 0) is not ported to "
                "paddle_tpu_torch yet (ROADMAP A9): use num_workers=0")
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
        else:
            getitems = getattr(self.dataset, "__getitems__", None)
            if getitems is not None and \
                    self.collate_fn is default_collate_fn:
                for idxs in self.batch_sampler:
                    batch = getitems(list(idxs))
                    # tuple samples collate to a list of field arrays
                    yield list(batch) if isinstance(batch, tuple) \
                        else batch
                return
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        for batch in self._batches():
            yield _to_tensors(batch)

    @staticmethod
    def from_generator(feed_list=None, capacity=None, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True):
        raise NotImplementedError("from_generator is legacy; use DataLoader")


def get_worker_info():
    return None
