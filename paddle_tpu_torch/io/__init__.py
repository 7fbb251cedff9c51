"""Datasets, samplers and the DataLoader (counterpart:
``paddle_tpu/io/__init__.py``).

Batches are collated on the host into CPU tensors (``torch.from_numpy``
of the stacked numpy samples, ``torch.stack`` of tensors); the consumer
(``hapi.Model``) moves them to its device. With ``shuffle=False`` the
batches are the JAX package's, batch for batch.

Randomness: ``DistributedBatchSampler`` shuffles with numpy's
``default_rng(epoch)`` as the JAX package does, index for index. Where
the JAX package draws from its threefry key or Python's ``random``
(``shuffle=True``, ``RandomSampler``, ``random_split``,
``WeightedRandomSampler``, ``SubsetRandomSampler``), the port draws from
a ``torch.Generator`` (the ``generator`` given, else torch's default
one, which ``torch.manual_seed`` seeds), which torch cannot make equal:
the same lengths, disjointness and frequencies, other indices.

``DataLoader(num_workers > 0)``, as the JAX package's: a map-style
dataset under a batch sampler, where the platform can ``fork``, runs
``num_workers`` worker processes that fetch samples and hand their numpy
arrays back through one shared-memory segment a batch, handed their
indices ``num_workers * prefetch_factor`` batches ahead; an
``IterableDataset`` (or a platform without ``fork``) takes a thread that
prefetches ``num_workers * prefetch_factor`` batches. Collation stays in
the consumer's process. A worker touches no CUDA tensor and makes no
CUDA call, so the pool may fork after CUDA is initialised; it ignores
SIGINT and dies on SIGTERM without running a Python handler it
inherited. Workers are killed, joined and every segment unlinked when
the iterator ends, also when the consumer stops early.
"""
from __future__ import annotations

import glob
import multiprocessing as mp
import os
import queue as _queue
import signal
import threading
import uuid
import warnings

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler",
           "SubsetRandomSampler", "DataLoader", "get_worker_info",
           "default_collate_fn", "default_convert_fn"]

RESULT_TIMEOUT_S = 120.0   # a wait on the workers before checking on them


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


class ComposeDataset(Dataset):
    """Item i is the fields of every dataset's item i, flattened into one
    tuple; the length is the shortest dataset's."""

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
    """The iterable datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Map-style datasets end to end: index i addresses the dataset whose
    cumulative length first exceeds it (negative indices from the end)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets should not be an empty iterable")
        for d in self.datasets:
            if isinstance(d, IterableDataset):
                raise TypeError(
                    "ConcatDataset does not support IterableDataset")
        self.cumulative_sizes = [int(x) for x in np.cumsum(
            [len(d) for d in self.datasets])]

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        n = len(self)
        if idx < 0:
            if idx < -n:
                raise IndexError("index out of range")
            idx += n
        elif idx >= n:
            raise IndexError("index out of range")
        di = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        prev = self.cumulative_sizes[di - 1] if di > 0 else 0
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint :class:`Subset` s of the given lengths (or fractions of
    the length, the last taking the rest) over one ``torch.randperm``
    from ``generator``."""
    total = len(dataset)
    lengths = list(lengths)
    if sum(lengths) != total:
        if all(0 < n < 1 for n in lengths):
            lengths = [int(n * total) for n in lengths]
            lengths[-1] = total - sum(lengths[:-1])
        else:
            raise ValueError("sum of lengths != dataset size")
    perm = torch.randperm(total, generator=generator).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
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


class WeightedRandomSampler(Sampler):
    """``num_samples`` indices drawn with probability proportional to
    ``weights`` (``torch.multinomial`` from ``generator``)."""

    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = torch.as_tensor(np.asarray(weights, np.float64))
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        return iter(torch.multinomial(self.weights, self.num_samples,
                                      self.replacement,
                                      generator=self.generator).tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """The given indices in an order drawn from ``generator``."""

    def __init__(self, indices, generator=None):
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        order = torch.randperm(len(self.indices), generator=self.generator)
        return iter([self.indices[i] for i in order.tolist()])

    def __len__(self):
        return len(self.indices)


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


def _world():
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return (torch.distributed.get_world_size(),
                torch.distributed.get_rank())
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """The batches of one data-parallel rank: the indices (shuffled by
    numpy's ``default_rng(epoch)``, as the JAX package's) padded to a
    multiple of the ranks by repeating the first ones, then every
    ``num_replicas``-th from ``rank``. The ranks default to
    ``torch.distributed``'s world when it is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = (np.random.default_rng(self.epoch).permutation(n).tolist()
                   if self.shuffle else list(range(n)))
        indices += indices[:self.total_size - n]
        local = indices[self.local_rank:self.total_size:self.nranks]
        for i in range(0, len(local), self.batch_size):
            batch = local[i:i + self.batch_size]
            if len(batch) == self.batch_size or not self.drop_last:
                yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id_, num_workers, dataset):
        self.id = id_
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    """In a DataLoader worker (process or prefetch thread): its ``id``,
    ``num_workers`` and ``dataset``; elsewhere None."""
    return getattr(_worker_info, "info", None)


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


def default_convert_fn(sample):
    """One sample's leaves as tensors, with no batch dimension (the
    ``batch_size=None`` path)."""
    if isinstance(sample, torch.Tensor):
        return sample
    if isinstance(sample, (np.ndarray, np.generic, int, float)):
        return torch.as_tensor(np.asarray(sample))
    if isinstance(sample, tuple) and hasattr(sample, "_fields"):
        return type(sample)(*(default_convert_fn(s) for s in sample))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_convert_fn(s) for s in sample)
    if isinstance(sample, dict):
        return {k: default_convert_fn(v) for k, v in sample.items()}
    return sample


# -- worker processes: samples cross in one shared-memory segment a batch ----

def _host_pack(samples):
    """The samples with each numpy array and CPU tensor replaced by a
    descriptor of its place in the returned list of numpy arrays (a
    tensor crosses as numpy, bf16 as its int16 bits: torch's own pickling
    of a tensor hands a file descriptor over, which a worker that has
    exited cannot serve)."""
    arrays = []

    def scan(o):
        tag = "A"
        if isinstance(o, torch.Tensor):
            tag = "B" if o.dtype == torch.bfloat16 else "T"
            o = o.detach().view(torch.int16) if tag == "B" else o.detach()
            o = o.numpy()
        if isinstance(o, np.ndarray):
            arrays.append(np.ascontiguousarray(o))
            return (tag, len(arrays) - 1)
        if isinstance(o, (list, tuple)):
            return (type(o).__name__, [scan(x) for x in o])
        if isinstance(o, dict):
            return ("dict", [(k, scan(v)) for k, v in o.items()])
        return ("S", o)

    return [scan(s) for s in samples], arrays


def _host_unpack(spec, arrays):
    def un(s):
        tag = s[0]
        if tag == "A":
            return arrays[s[1]]
        if tag in ("T", "B"):
            t = torch.from_numpy(arrays[s[1]])
            return t.view(torch.bfloat16) if tag == "B" else t
        if tag == "S":
            return s[1]
        if tag == "dict":
            return {k: un(v) for k, v in s[1]}
        seq = [un(x) for x in s[1]]
        return tuple(seq) if tag == "tuple" else seq

    return [un(s) for s in spec]


def _shm_pack(arrays, seg_name):
    """``arrays`` written into one new shared-memory segment
    ``seg_name``: ``(name, [(offset, shape, dtype), ...])``. The consumer
    owns the segment from here on (it unlinks it after reading)."""
    from multiprocessing import resource_tracker, shared_memory

    offsets = np.cumsum([0] + [a.nbytes for a in arrays]).tolist()
    shm = shared_memory.SharedMemory(create=True, size=max(offsets[-1], 1),
                                     name=seg_name)
    for a, off in zip(arrays, offsets):
        view = np.frombuffer(shm.buf, dtype=a.dtype, count=a.size,
                             offset=off).reshape(a.shape)
        np.copyto(view, a)
        del view
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return seg_name, [(off, a.shape, str(a.dtype))
                      for a, off in zip(arrays, offsets)]


def _shm_unpack(name, layout):
    """The arrays of :func:`_shm_pack`, copied out of the segment, which
    is then unlinked."""
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=name)
    try:
        return [np.frombuffer(shm.buf, dtype=dt, count=int(np.prod(shape)),
                              offset=off).reshape(shape).copy()
                for off, shape, dt in layout]
    finally:
        shm.close()
        shm.unlink()


def _sweep_segments(token):
    """Unlink every segment named after ``token`` by its path: a worker
    killed between creating a segment and sizing it leaves an empty one,
    which ``SharedMemory`` cannot open."""
    for path in glob.glob(f"/dev/shm/{token}_*"):
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


def _process_worker(wid, num_workers, dataset, index_q, result_q,
                    worker_init_fn, shm_token):
    """A worker process: ``dataset[i]`` for each batch of indices from
    ``index_q`` until ``None``, the samples onto ``result_q`` as numpy
    (their arrays in a segment named after ``shm_token`` when it is
    given, else pickled); a dataset's exception goes back as its
    message."""
    # the forked copy of the consumer's stack must never run again: no
    # Python handler it inherited may turn a signal into an exception
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    torch.set_num_threads(1)
    _worker_info.info = _WorkerInfo(wid, num_workers, dataset)
    if worker_init_fn:
        worker_init_fn(wid)
    seq = 0
    while True:
        item = index_q.get()
        if item is None:
            return
        i, indices = item
        try:
            spec, arrays = _host_pack([dataset[j] for j in indices])
            if shm_token and arrays:
                result_q.put((i, "shm", (spec, _shm_pack(
                    arrays, f"{shm_token}_{wid}_{seq}"))))
                seq += 1
            else:
                result_q.put((i, "raw", (spec, arrays)))
        except Exception as e:  # noqa: BLE001 - handed to the consumer
            result_q.put((i, "err", f"{type(e).__name__}: {e}"))


class DataLoader:
    """Batches of a map-style dataset through a :class:`BatchSampler`
    (or the ``batch_sampler`` given), or of an :class:`IterableDataset`
    in its order, collated on the host. ``batch_size=None`` yields the
    samples one by one, unbatched (synchronously, with a warning when
    ``num_workers`` asks for workers). ``num_workers > 0`` fetches in
    worker processes or a prefetch thread (see the module note), with
    ``worker_init_fn(worker_id)`` run in each worker first and
    ``use_shared_memory=False`` sending the samples pickled instead."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self._user_collate = collate_fn is not None
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
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
            else default_convert_fn(sample)

    def __iter__(self):
        if self.num_workers and self.batch_sampler is None \
                and not self._iterable:
            warnings.warn(
                "DataLoader(batch_size=None) iterates synchronously; "
                f"num_workers={self.num_workers} is not used on the "
                "unbatched path")
        elif self.num_workers:
            if not self._iterable and \
                    "fork" in mp.get_all_start_methods():
                return self._iter_procs()
            return self._iter_prefetch()
        return self._iter_sync()

    def _iter_sync(self):
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

    def _iter_prefetch(self):
        """One thread runs the synchronous iteration (as worker 0 of 1)
        ``num_workers * prefetch_factor`` batches ahead; it stops when
        the consumer does."""
        q = _queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        stop = threading.Event()
        done = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def producer():
            _worker_info.info = _WorkerInfo(0, 1, self.dataset)
            try:
                if self.worker_init_fn:
                    self.worker_init_fn(0)
                for b in self._iter_sync():
                    if not put(("ok", b)):
                        return
            except Exception as e:  # noqa: BLE001 - handed to the consumer
                put(("err", e))
            put(("end", done))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    kind, item = q.get(timeout=RESULT_TIMEOUT_S)
                except _queue.Empty:
                    if t.is_alive():
                        continue
                    raise RuntimeError("DataLoader prefetch thread ended "
                                       "without its last batch") from None
                if kind == "end":
                    return
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _iter_procs(self):
        """``num_workers`` forked processes over the batch sampler's
        batches; the batches are yielded in order and collated here."""
        from multiprocessing import resource_tracker

        ctx = mp.get_context("fork")
        batches = list(self.batch_sampler)
        # the workers share this process's tracker rather than each
        # starting its own
        resource_tracker.ensure_running()
        token = (f"ptt{os.getpid()}_{uuid.uuid4().hex[:8]}"
                 if self.use_shared_memory else None)
        # no feeder thread here: an index goes out as a batch is taken,
        # num_workers * prefetch_factor batches ahead, then one None a
        # worker
        index_q, result_q = ctx.SimpleQueue(), ctx.Queue()
        pending = iter(list(enumerate(batches))
                       + [None] * self.num_workers)
        for _ in range(self.num_workers * self.prefetch_factor):
            index_q.put(next(pending, None))
        procs = [ctx.Process(target=_process_worker, daemon=True, args=(
            w, self.num_workers, self.dataset, index_q, result_q,
            self.worker_init_fn, token)) for w in range(self.num_workers)]
        for p in procs:
            p.start()
        results = {}
        try:
            for want in range(len(batches)):
                while want not in results:
                    try:
                        i, kind, payload = result_q.get(
                            timeout=RESULT_TIMEOUT_S)
                    except _queue.Empty:
                        dead = [p.exitcode for p in procs
                                if p.exitcode not in (None, 0)]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader worker(s) died (exit codes "
                                f"{dead})") from None
                        continue
                    if kind == "err":
                        raise RuntimeError(f"DataLoader worker failed on "
                                           f"batch {i}: {payload}")
                    spec, arrays = payload
                    if kind == "shm":
                        arrays = _shm_unpack(*arrays)
                    results[i] = _host_unpack(spec, arrays)
                index_q.put(next(pending, None))
                yield self.collate_fn(results.pop(want))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            # the segments no one read, queued or not: a killed worker's
            # last message may be cut, so none is read here
            if token:
                _sweep_segments(token)
            index_q.close()
            result_q.close()
