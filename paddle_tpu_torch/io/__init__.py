"""Datasets, samplers and the DataLoader (counterpart:
``paddle_tpu/io/__init__.py``).

Batches are collated on the host into CPU tensors (``torch.from_numpy``
of the stacked numpy samples, ``torch.stack`` of tensors); the consumer
(``hapi.Model``) moves them to its device. With ``shuffle=False`` the
batches are the JAX package's, batch for batch. With ``shuffle=True`` the
order comes from ``torch.randperm`` over a ``torch.Generator`` (the
sampler's ``generator``, else torch's default one, which
``torch.manual_seed`` seeds): the JAX package permutes with its threefry
key, which torch does not reproduce, so the two shuffle differently.

``DataLoader(num_workers > 0)`` (the JAX package's worker pool) is not
ported and raises.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays or tensors: item i is ``(t[i] for t in
    tensors)``."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


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
    """A permutation (or, with ``replacement``, uniform draws) from
    ``generator``, a ``torch.Generator``, or torch's default generator."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,),
                                generator=self.generator)
        else:
            idx = torch.randperm(n, generator=self.generator)[
                :self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

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


def default_collate_fn(batch):
    """Stack a list of samples: tensors with ``torch.stack``, numpy
    arrays and scalars through numpy, tuples and dicts field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch, dim=0)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch, axis=0))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _convert(sample):
    """One sample's leaves as tensors, with no batch dimension."""
    if isinstance(sample, torch.Tensor):
        return sample
    if isinstance(sample, (np.ndarray, np.generic, int, float)):
        return torch.as_tensor(np.asarray(sample))
    if isinstance(sample, (list, tuple)):
        return type(sample)(_convert(s) for s in sample)
    if isinstance(sample, dict):
        return {k: _convert(v) for k, v in sample.items()}
    return sample


class DataLoader:
    """Batches of a map-style dataset through a :class:`BatchSampler`
    (or the ``batch_sampler`` given), or of an :class:`IterableDataset`
    in its order, collated on the host. ``batch_size=None`` yields the
    samples one by one, unbatched. Only ``num_workers=0`` is ported."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers:
            raise NotImplementedError(
                f"DataLoader(num_workers={num_workers}): worker processes "
                "are not ported to paddle_tpu_torch yet; use num_workers=0")
        self.dataset = dataset
        self._user_collate = collate_fn is not None
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._iterable = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable or (batch_sampler is None and batch_size is None):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _one(self, sample):
        return self.collate_fn(sample) if self._user_collate \
            else _convert(sample)

    def __iter__(self):
        if self._iterable:
            if self.batch_size is None:
                yield from (self._one(s) for s in self.dataset)
                return
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self._one(self.dataset[i])
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])
