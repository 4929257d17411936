"""``DataLoader``, from ``tpu_mx/gluon/data/dataloader.py``: batches of
a dataset by a (batch) sampler, with ``batchify_fn``, prefetch and two
kinds of workers.

``num_workers=0`` loads in the consumer's thread.  Thread workers
(the default) load batches in order behind a window of ``prefetch``
batches, each under the context the iteration started in, so the
default batchify makes its arrays there.  ``thread_pool=False`` forks
process workers that ship each batch back through one POSIX shared
memory segment (written through a view, copied out once by the parent,
which unlinks it).  A forked child runs no torch operation: CUDA cannot
start in a child forked after the parent started it, and torch's
intra-op pool may hang after a fork.  So the children batchify in numpy
(samples that are arrays or tensors are refused, for a custom
``batchify_fn`` too), and the parent wraps each batch in arrays on its
current context.
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from ...context import current_context
from ...io.io import _batch_array
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _numpy_batchify(data):
    """:func:`default_batchify_fn` without the array wrap: what process
    workers run.  A sample that is an array or a tensor is refused (its
    conversion would run torch in the forked child)."""
    if isinstance(data[0], (NDArray, torch.Tensor)):
        raise TypeError(
            "process workers (thread_pool=False) require numpy samples; "
            "this dataset returns NDArray — return numpy from __getitem__ "
            "or use thread workers (thread_pool=True)")
    if isinstance(data[0], tuple):
        transposed = list(zip(*data))
        return tuple(_numpy_batchify(list(t)) for t in transposed)
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _flatten_np(x):
    """``(leaves, structure)`` of nested tuples and lists of numpy
    arrays; an array or tensor leaf is refused (this runs in forked
    workers, for a custom ``batchify_fn`` too)."""
    if isinstance(x, (NDArray, torch.Tensor)):
        raise TypeError(
            "process workers (thread_pool=False) require numpy batches; "
            "got NDArray — return numpy from the dataset/batchify_fn or "
            "use thread workers (thread_pool=True)")
    if isinstance(x, (tuple, list)):
        leaves, struct = [], []
        for e in x:
            l, s = _flatten_np(e)
            leaves.extend(l)
            struct.append(s)
        return leaves, (isinstance(x, tuple), struct)
    return [np.ascontiguousarray(np.asarray(x))], None


def _unflatten(leaves, struct, wrap):
    it = iter(leaves)

    def rebuild(s):
        if s is None:
            return wrap(next(it))
        is_tuple, children = s
        vals = [rebuild(c) for c in children]
        return tuple(vals) if is_tuple else vals

    return rebuild(struct)


def _shm_worker_loop(dataset, batchify, task_q, result_q):
    """A process worker: load and batchify (numpy only), write the leaves
    into one fresh shared-memory segment and send its name and layout
    back.  The parent unlinks it; the worker closes its mapping."""
    from multiprocessing import shared_memory
    while True:
        item = task_q.get()
        if item is None:
            return
        seq, indices = item
        shm = None
        try:
            batch = batchify([dataset[i] for i in indices])
            leaves, struct = _flatten_np(batch)
            total = max(1, sum(a.nbytes for a in leaves))
            shm = shared_memory.SharedMemory(create=True, size=total)
            off, metas = 0, []
            for a in leaves:
                dst = np.frombuffer(shm.buf, dtype=a.dtype, count=a.size,
                                    offset=off).reshape(a.shape)
                dst[...] = a
                del dst
                metas.append((a.dtype.str, a.shape, off))
                off += a.nbytes
            shm.close()
            result_q.put((seq, shm.name, metas, struct, None))
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            if shm is not None:     # the failed batch's segment
                shm.close()
                shm.unlink()
            result_q.put((seq, None, None, None,
                          f"{type(e).__name__}: {e}"))


def default_batchify_fn(data):
    """Stack samples into a batch of arrays on the current context."""
    if isinstance(data[0], NDArray):
        return _batch_array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        transposed = list(zip(*data))
        return tuple(default_batchify_fn(list(t)) for t in transposed)
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return _batch_array(arr)


class DataLoader:
    """Batches of ``dataset`` (see the module's docstring)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(num_workers, 1))

    def _load_batch(self, indices):
        samples = [self._dataset[i] for i in indices]
        return self._batchify_fn(samples)

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return
        if self._thread_pool:
            yield from self._threaded_iter()
        else:
            yield from self._process_iter()

    def _process_iter(self):
        """Forked workers, batches back through shared memory, delivered
        in order behind a sliding prefetch window."""
        import multiprocessing as mp
        from multiprocessing import shared_memory
        ctx = mp.get_context("fork")
        batches = list(self._batch_sampler)
        task_q, result_q = ctx.Queue(), ctx.Queue()
        batchify = self._batchify_fn
        if batchify is default_batchify_fn:
            batchify = _numpy_batchify
        procs = [ctx.Process(target=_shm_worker_loop,
                             args=(self._dataset, batchify, task_q, result_q),
                             daemon=True)
                 for _ in range(self._num_workers)]
        for p in procs:
            p.start()
        window = max(self._prefetch, self._num_workers)
        issued = 0
        pending = {}
        try:
            for _ in range(min(window, len(batches))):
                task_q.put((issued, batches[issued]))
                issued += 1
            for seq in range(len(batches)):
                while seq not in pending:
                    try:
                        got = result_q.get(timeout=self._timeout)
                    except _queue.Empty:
                        dead = [i for i, p in enumerate(procs)
                                if not p.is_alive()]
                        raise RuntimeError(
                            "DataLoader process-worker timeout"
                            + (f"; dead workers: {dead}" if dead else ""))
                    pending[got[0]] = got[1:]
                shm_name, metas, struct, err = pending.pop(seq)
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                shm = shared_memory.SharedMemory(name=shm_name)
                try:
                    leaves = []
                    for dtype, shape, off in metas:
                        cnt = int(np.prod(shape, dtype=np.int64)) if shape \
                            else 1
                        view = np.frombuffer(shm.buf, dtype=dtype, count=cnt,
                                             offset=off)
                        leaves.append(np.array(view.reshape(shape)))
                        del view    # before close: no exported pointer
                finally:
                    shm.close()
                    shm.unlink()
                if issued < len(batches):
                    task_q.put((issued, batches[issued]))
                    issued += 1
                batch = _unflatten(leaves, struct, _batch_array)
                yield batch
        finally:
            for _ in procs:
                task_q.put(None)
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
            # unlink the segments made but not consumed (an early close
            # or an error), so they do not pile up across epochs
            leftovers = [v[0] for v in pending.values()]
            while True:
                try:
                    got = result_q.get_nowait()
                except _queue.Empty:
                    break
                leftovers.append(got[1])
            for name in leftovers:
                if not name:
                    continue
                try:
                    seg = shared_memory.SharedMemory(name=name)
                    seg.close()
                    seg.unlink()
                except FileNotFoundError:
                    pass

    def _threaded_iter(self):
        """Worker threads, batches delivered in order, at most
        ``prefetch`` in flight; each worker loads under the context the
        iteration started in.  A worker takes its slot in the window
        before its task: the reference's workers take the task first, so
        a worker holding the batch the consumer waits for can wait for a
        slot that later batches hold, and the loader stalls until its
        timeout."""
        batches = list(self._batch_sampler)
        results = {}
        results_lock = threading.Lock()
        results_ready = threading.Condition(results_lock)
        task_q = _queue.Queue()
        for seq, indices in enumerate(batches):
            task_q.put((seq, indices))
        stop = threading.Event()
        budget = threading.Semaphore(max(self._prefetch, self._num_workers))
        ctx = current_context()

        def worker():
            with ctx:
                work()

        def work():
            while not stop.is_set():
                while not budget.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                try:
                    seq, indices = task_q.get_nowait()
                except _queue.Empty:
                    budget.release()
                    return
                try:
                    batch = self._load_batch(indices)
                except Exception as e:  # noqa: BLE001 — raised in the consumer
                    batch = e
                with results_ready:
                    results[seq] = batch
                    results_ready.notify_all()

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for w in workers:
            w.start()
        try:
            for seq in range(len(batches)):
                with results_ready:
                    while seq not in results:
                        if not results_ready.wait(self._timeout):
                            raise RuntimeError("DataLoader worker timeout")
                    batch = results.pop(seq)
                budget.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()

    def __len__(self):
        return len(self._batch_sampler)
