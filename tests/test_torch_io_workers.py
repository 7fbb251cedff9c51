"""DataLoader workers and the rest of ``io`` in paddle_tpu_torch, on the
CPU.

- ``num_workers=2`` gives the batches of ``num_workers=0``, batch for
  batch: forked worker processes over shared memory (numpy arrays, CPU
  tensors, dicts; ``use_shared_memory=False``), and the prefetch thread
  of an ``IterableDataset``; ``get_worker_info`` and ``worker_init_fn``
  hold in the worker; a dataset's error reaches the consumer; an early
  ``break`` leaves no worker process, thread or shared-memory segment
  behind; ``batch_size=None`` iterates synchronously and warns.
- ``ComposeDataset``, ``ChainDataset``, ``ConcatDataset``,
  ``DistributedBatchSampler`` (numpy's ``default_rng(epoch)``, as the
  JAX package) and ``default_convert_fn`` against paddle_tpu's, index
  for index; ``random_split``, ``WeightedRandomSampler`` and
  ``SubsetRandomSampler`` draw from a ``torch.Generator`` where the JAX
  package draws threefry or Python's ``random``: lengths, disjointness,
  determinism under one generator and frequencies.

The datasets are tiny and every wait has the loader's own generous
timeout; nothing here sleeps.
"""
import gc
import glob
import multiprocessing as mp
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu_torch import io

_INIT = {}


def _rows(n=10, width=3):
    return np.arange(n * width, dtype=np.int32).reshape(n, width)


class _Probe(io.Dataset):
    """Item i: i, the worker's id and count, what ``worker_init_fn`` set
    there, and the process id."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        info = io.get_worker_info()
        return np.asarray([i, info.id, info.num_workers,
                           _INIT.get("wid", -1), os.getpid()], np.int64)


def _init(wid):
    _INIT["wid"] = wid


class _Stream(io.IterableDataset):
    def __iter__(self):
        info = io.get_worker_info()
        for i in range(7):
            yield (np.full(2, i, np.float32),
                   -1 if info is None else info.num_workers)


class _Fails(io.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise KeyError("row 2 is missing")
        return np.zeros(2)


def _segments():
    return glob.glob(f"/dev/shm/ptt{os.getpid()}_*")


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


class _Mixed(io.Dataset):
    """numpy, a CPU tensor, a bf16 tensor (its bits cross as int16), a
    dict and a string."""

    def __len__(self):
        return 9

    def __getitem__(self, i):
        return {"ids": np.arange(i, i + 4, dtype=np.int64),
                "x": torch.full((2,), float(i)),
                "h": torch.full((2,), i / 3).bfloat16(),
                "tag": f"row{i}"}


@pytest.mark.parametrize("kw", [dict(), dict(use_shared_memory=False),
                                dict(prefetch_factor=4)],
                         ids=["shm", "pickled", "prefetch4"])
def test_process_workers_give_the_synchronous_batches(kw):
    for data in (io.TensorDataset([_rows(), _rows() * 2]), _Mixed()):
        want = list(io.DataLoader(data, batch_size=4))
        got = list(io.DataLoader(data, batch_size=4, num_workers=2, **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    assert not mp.active_children() and not _segments()


def test_more_workers_than_cores_keep_the_batches_in_order():
    """Workers share one index queue and one result queue: with more
    workers than cores and few batches ahead, every batch comes once and
    in order."""
    data = io.TensorDataset([_rows(200), _rows(200)])
    want = [b[0].tolist() for b in io.DataLoader(data, batch_size=3)]
    got = [b[0].tolist() for b in io.DataLoader(
        data, batch_size=3, num_workers=(os.cpu_count() or 1) + 4,
        prefetch_factor=2)]
    assert got == want
    assert not mp.active_children() and not _segments()


def test_worker_info_and_init_fn_hold_in_the_child():
    got = torch.cat(list(io.DataLoader(_Probe(), batch_size=2,
                                       num_workers=2,
                                       worker_init_fn=_init)))
    assert got[:, 0].tolist() == list(range(6))
    assert set(got[:, 1].tolist()) <= {0, 1}
    assert (got[:, 2] == 2).all() and torch.equal(got[:, 3], got[:, 1])
    assert os.getpid() not in got[:, 4].tolist()
    assert io.get_worker_info() is None and "wid" not in _INIT


def test_thread_prefetch_of_an_iterable_dataset():
    want = list(io.DataLoader(_Stream(), batch_size=3))
    got = list(io.DataLoader(_Stream(), batch_size=3, num_workers=2))
    assert [b[0].tolist() for b in got] == [b[0].tolist() for b in want]
    assert [b[1].tolist() for b in want] == [[-1] * 3, [-1] * 3, [-1]]
    # the prefetch thread is worker 0 of 1
    assert [b[1].tolist() for b in got] == [[1] * 3, [1] * 3, [1]]


def test_early_break_leaves_nothing_behind():
    threads = threading.active_count()
    data = io.TensorDataset([_rows(40), _rows(40)])
    for loader in (io.DataLoader(data, batch_size=2, num_workers=2),
                   io.DataLoader(_Stream(), batch_size=1, num_workers=1)):
        for i, _ in enumerate(loader):
            if i == 1:
                break
        gc.collect()
    assert not mp.active_children()
    assert not _segments()
    assert threading.active_count() == threads


def test_workers_run_no_inherited_signal_handler(tmp_path):
    """A worker ends without running a Python SIGTERM handler that its
    consumer had installed: the forked copy of the consumer's stack must
    not run (an exception out of it would resume the consumer's code in
    the worker)."""
    import signal
    log, me = tmp_path / "handled", os.getpid()

    def handler(*_):
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\n")
        if os.getpid() != me:
            os._exit(0)    # a worker that ran it ends, so the test fails
    old = signal.signal(signal.SIGTERM, handler)
    try:
        data = io.TensorDataset([_rows(40), _rows(40)])
        for i, _ in enumerate(io.DataLoader(data, batch_size=1,
                                            num_workers=2)):
            if i == 1:
                break
        gc.collect()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert not log.exists()
    assert not mp.active_children() and not _segments()


def test_the_sweep_unlinks_empty_segments_too():
    """A worker killed between creating its segment and sizing it leaves
    an empty one; the consumer's sweep unlinks it with the rest."""
    from paddle_tpu_torch.io import _sweep_segments
    token = f"ptt{os.getpid()}_sweeptest"
    for name, size in ((f"{token}_0_0", 0), (f"{token}_1_3", 24)):
        with open(f"/dev/shm/{name}", "wb") as f:
            f.write(b"\0" * size)
    _sweep_segments(token)
    assert not _segments()


def test_worker_errors_reach_the_consumer():
    with pytest.raises(RuntimeError, match="row 2 is missing"):
        list(io.DataLoader(_Fails(), batch_size=1, num_workers=2))
    assert not mp.active_children() and not _segments()


def test_unbatched_with_workers_iterates_synchronously_and_warns():
    data = io.TensorDataset([_rows(3)])
    with pytest.warns(UserWarning, match="synchronously"):
        got = list(io.DataLoader(data, batch_size=None, num_workers=2))
    assert [g[0].tolist() for g in got] == _rows(3).tolist()


def _jax_list(x):
    return np.asarray(x._data if hasattr(x, "_data") else x).tolist()


def test_datasets_match_jax_index_for_index():
    a, b = _rows(5), _rows(7) * 10
    pairs = [
        (io.ComposeDataset([io.TensorDataset([a]), io.TensorDataset([b])]),
         jio.ComposeDataset([jio.TensorDataset([a]),
                             jio.TensorDataset([b])])),
        (io.ConcatDataset([io.TensorDataset([a]), io.TensorDataset([b])]),
         jio.ConcatDataset([jio.TensorDataset([a]),
                            jio.TensorDataset([b])])),
    ]
    for mine, ref in pairs:
        assert len(mine) == len(ref)
        for i in list(range(len(ref))) + [-1, -len(ref)]:
            assert [x.tolist() for x in mine[i]] == \
                [_jax_list(x) for x in ref[i]], i
    with pytest.raises(IndexError):
        pairs[1][0][len(pairs[1][0])]
    with pytest.raises(TypeError):
        io.ConcatDataset([_Stream()])
    chain = list(iter(io.ChainDataset([_Stream(), _Stream()])))
    ref = list(iter(jio.ChainDataset([_Stream(), _Stream()])))
    assert [c[0].tolist() for c in chain] == [r[0].tolist() for r in ref]


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    data = io.TensorDataset([_rows(23)])
    for rank in range(3):
        mine = io.DistributedBatchSampler(data, 4, num_replicas=3,
                                          rank=rank, shuffle=shuffle,
                                          drop_last=drop_last)
        ref = jio.DistributedBatchSampler(data, 4, num_replicas=3,
                                          rank=rank, shuffle=shuffle,
                                          drop_last=drop_last)
        for epoch in (0, 3):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(mine) == list(ref) and len(mine) == len(ref)
    default = io.DistributedBatchSampler(data, 4)
    assert (default.nranks, default.local_rank) == (1, 0)


def test_default_convert_fn_matches_jax():
    sample = {"a": np.arange(3), "b": (np.float32(2.5), 7), "c": "s"}
    mine, ref = io.default_convert_fn(sample), jio.default_convert_fn(
        sample)
    assert mine["a"].tolist() == _jax_list(ref["a"])
    assert [x.item() for x in mine["b"]] == [
        np.asarray(x._data).item() for x in ref["b"]]
    assert mine["c"] == ref["c"] == "s"


def test_random_split_and_samplers_draw_from_a_torch_generator():
    data = io.TensorDataset([_rows(20)])
    parts = io.random_split(data, [0.25, 0.75],
                            generator=torch.Generator().manual_seed(5))
    ref = jio.random_split(data, [0.25, 0.75])
    assert [len(p) for p in parts] == [len(r) for r in ref] == [5, 15]
    idx = [i for p in parts for i in p.indices]
    assert sorted(idx) == list(range(20))
    again = io.random_split(data, [5, 15],
                            generator=torch.Generator().manual_seed(5))
    assert [p.indices for p in again] == [p.indices for p in parts]
    with pytest.raises(ValueError):
        io.random_split(data, [5, 5])

    sub = io.SubsetRandomSampler([3, 9, 4, 11],
                                 generator=torch.Generator().manual_seed(1))
    order = list(sub)
    assert sorted(order) == [3, 4, 9, 11] and len(sub) == 4
    assert sorted(jio.SubsetRandomSampler([3, 9, 4, 11])) == sorted(order)

    weights = [1.0, 0.0, 3.0, 4.0]
    w = io.WeightedRandomSampler(weights, 4000,
                                 generator=torch.Generator().manual_seed(2))
    counts = np.bincount(list(w), minlength=4) / 4000
    ref_counts = np.bincount(list(jio.WeightedRandomSampler(weights, 4000)),
                             minlength=4) / 4000
    np.testing.assert_allclose(counts, [0.125, 0.0, 0.375, 0.5], atol=0.03)
    np.testing.assert_allclose(counts, ref_counts, atol=0.05)
    no_repeat = list(io.WeightedRandomSampler(weights, 3, replacement=False))
    assert len(set(no_repeat)) == 3 and 1 not in no_repeat
