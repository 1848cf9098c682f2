"""Background-prefetching loaders: dataset / packer threads or processes
overlap host work (decode, resize, pack) with device steps, the role of torch
DataLoader workers + pin_memory + SimpleCustomBatch.cuda() in the reference
(data/dataset_base.py:640-796).

The port's own copy of g2vlm_tpu/train/dataloader.py, which it does not
import; tests/test_torch_dataloader.py holds it to the JAX package's tests.
Only numpy trees cross a loader's queue: the consumer, in the main process,
uploads them. A worker of `ProcessPrefetchLoader` imports the port afresh
(`spawn`) and must touch no CUDA state: no `torch.cuda` call, no pinned
tensor, no tensor on the card in what `make_iter` builds or yields.

One difference: a worker's every put (an item, an error, the end sentinel)
gives up once `close()` has set the stop event, and `close()` waits for the
workers to end and empties the queue. The JAX workers put the sentinel with
a blocking put, so one that ends beside a full queue blocks for good and
keeps the queued items alive."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class _WorkerDone:
    """End-of-stream sentinel enqueued when a worker's iterator exhausts."""


class PrefetchLoader:
    """Wraps an iterable with N producer threads and a bounded queue.

    Each worker runs its own iterator built by `make_iter(worker_id)` (the
    dataset shards by worker_id, matching the reference's per-worker file
    splits). Items interleave nondeterministically across workers, like a
    torch DataLoader with num_workers > 1.
    """

    def __init__(
        self,
        make_iter: Callable[[int], Iterable],
        num_workers: int = 1,
        prefetch: int = 4,
        transform: Optional[Callable] = None,
    ):
        self.make_iter = make_iter
        self.num_workers = max(1, num_workers)
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.transform = transform
        self._stop = threading.Event()
        self._threads = []
        self._started = False

    def _put(self, item) -> bool:
        """Puts `item`, unless close() stops the loader first."""
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, wid: int):
        try:
            for item in self.make_iter(wid):
                if self._stop.is_set():
                    return
                if self.transform is not None:
                    item = self.transform(item)
                if not self._put(item):
                    return
        except Exception as e:  # surface worker failures to the consumer
            self._put(e)
        finally:
            # end-of-stream sentinel: finite iterators (eval sweeps, smoke
            # runs) terminate the consumer instead of deadlocking on get()
            self._put(_WorkerDone())

    def _start(self):
        for wid in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(wid,), daemon=True)
            t.start()
            self._threads.append(t)
        self._started = True

    def __iter__(self) -> Iterator:
        if not self._started:
            self._start()
        live = self.num_workers
        while live > 0:
            item = self.queue.get()
            if isinstance(item, _WorkerDone):
                live -= 1
                continue
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        """Stops the workers: each ends once its current item is built. Waits
        up to a minute for each, then empties the queue."""
        self._stop.set()
        for t in self._threads:
            t.join(60)
        while True:
            try:
                self.queue.get_nowait()
            except queue.Empty:
                break


class ProcessPrefetchLoader:
    """Process-based variant of PrefetchLoader for CPU-bound host pipelines.

    The thread loader above overlaps host and device work but cannot scale
    the pure-Python stages (packing, jsonl parsing) past the GIL; on a host
    feeding several GPUs the producers must be processes — the exact role of
    torch DataLoader num_workers>0 in the reference
    (data/dataset_base.py:640-796, persistent_workers=True).

    `make_iter(worker_id)` must be picklable (a module-level function or a
    functools.partial over picklables); each worker process builds its own
    iterator so dataset shards never cross process boundaries. Items are
    numpy trees pickled through an mp.Queue; exceptions propagate to the
    consumer. Iteration order interleaves nondeterministically across
    workers, like the thread loader.
    """

    def __init__(
        self,
        make_iter: Callable[[int], Iterable],
        num_workers: int = 1,
        prefetch: int = 4,
        transform: Optional[Callable] = None,
        mp_context: str = "spawn",
    ):
        import multiprocessing as mp

        self._mp = mp.get_context(mp_context)
        self.make_iter = make_iter
        self.num_workers = max(1, num_workers)
        self.transform = transform
        self.queue = self._mp.Queue(maxsize=max(prefetch, self.num_workers))
        self._stop = self._mp.Event()
        self._procs = []
        self._started = False

    @staticmethod
    def _put(q, stop, item) -> bool:
        """Puts `item`, unless close() stops the loader first; then the items
        still buffered for the pipe are dropped, so that the process can end."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        q.cancel_join_thread()
        return False

    @staticmethod
    def _worker(make_iter, transform, wid, q, stop):
        put = ProcessPrefetchLoader._put
        try:
            for item in make_iter(wid):
                if stop.is_set():
                    return
                if transform is not None:
                    item = transform(item)
                if not put(q, stop, item):
                    return
        except Exception as e:  # surface worker failures to the consumer
            try:
                put(q, stop, e)
            except Exception:
                put(q, stop, RuntimeError(f"worker {wid}: {type(e).__name__}: {e}"))
        finally:
            put(q, stop, _WorkerDone())

    def _start(self):
        for wid in range(self.num_workers):
            p = self._mp.Process(
                target=self._worker,
                args=(self.make_iter, self.transform, wid, self.queue, self._stop),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        self._started = True

    def __iter__(self) -> Iterator:
        if not self._started:
            self._start()
        live = self.num_workers
        while live > 0:
            item = self.queue.get()
            if isinstance(item, _WorkerDone):
                live -= 1
                continue
            if isinstance(item, Exception):
                self.close()
                raise item
            yield item

    def close(self):
        self._stop.set()
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
