"""Batching data loader with background prefetch (counterpart of
``surs_tpu/data/loader.py``).

Items are numpy dicts; batches stack array-valued keys along axis 0 and
list the others. Two overlap modes:

  * ``num_threads`` > 1 / ``prefetch``: a background thread builds
    batches ahead of the training step;
  * ``num_workers`` > 0: worker PROCESSES build batches in parallel,
    re-ordered to the deterministic epoch order, so the batches equal the
    single-process loader's.

Workers do host work only and never touch CUDA. The pool forks EAGERLY
at construction, so a caller that builds the loader before its model
(train/loop.py does) forks a process with no CUDA context: forking after
CUDA is initialised leaves the child a context it cannot use. When CUDA
is already initialised at construction, the pool uses spawn instead and
warns. Each worker also hides the GPUs from itself
(``CUDA_VISIBLE_DEVICES=""``) before it runs any item, so nothing an item
does can create a context (and spend device memory) in a worker.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import threading
import warnings
from typing import Dict, Iterator, List, Sequence

import numpy as np


def _fork_hazardous() -> bool:
    """True when this process has initialised CUDA through torch."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _get_item(dataset, i: int, resample_on_error: bool, seed: int,
              max_retries: int):
    """Item ``i``, optionally replaced by a random other item when it
    raises (the reference's BaseDataset failure-recovery contract)."""
    if not resample_on_error:
        return dataset[i]
    rng = np.random.default_rng(seed * 1000003 + i)
    for _ in range(max_retries):
        try:
            return dataset[i]
        except Exception:
            i = int(rng.integers(len(dataset)))
    return dataset[i]  # the final attempt surfaces the error


def _worker_loop(dataset, resample_on_error: bool, seed: int,
                 max_retries: int, in_q, out_q):
    """Worker-process loop: tasks are (tag, bi, idx_list), None stops.
    Results echo (tag, bi, batch_or_exception)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    while True:
        task = in_q.get()
        if task is None:
            return
        tag, bi, idxs = task
        try:
            out_q.put((tag, bi, collate([
                _get_item(dataset, i, resample_on_error, seed,
                          max_retries) for i in idxs])))
        except Exception as e:
            out_q.put((tag, bi, e))


def collate(items: Sequence[Dict]) -> Dict:
    out: Dict = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([it[k] for it in items], axis=0)
        else:
            out[k] = [it[k] for it in items]
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_threads: int = 1, prefetch: int = 2,
                 seed: int = 0, drop_last: bool = True,
                 resample_on_error: bool = False, max_retries: int = 8,
                 num_workers: int = 0, mp_context: str = "fork"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self.resample_on_error = resample_on_error
        self.max_retries = max_retries
        self.num_workers = max(0, num_workers)
        self._epoch = 0
        self._procs: List = []
        if self.num_workers > 0:
            if mp_context == "fork" and _fork_hazardous():
                warnings.warn(
                    "DataLoader: CUDA is already initialised in this "
                    "process; using spawn workers instead of fork (build "
                    "the loader before the model to fork).")
                mp_context = "spawn"
            ctx = mp.get_context(mp_context)
            self._in_q = ctx.Queue()
            self._out_q = ctx.Queue(maxsize=max(2, self.prefetch))
            self._procs = [
                ctx.Process(target=_worker_loop,
                            args=(self.dataset, self.resample_on_error,
                                  self.seed, self.max_retries,
                                  self._in_q, self._out_q), daemon=True)
                for _ in range(self.num_workers)]
            for p in self._procs:
                p.start()

    def close(self):
        """Stop the worker pool (idempotent)."""
        for _ in self._procs:
            try:
                self._in_q.put_nowait(None)
            except Exception:
                pass
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        self._procs = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _get(self, i: int):
        return _get_item(self.dataset, i, self.resample_on_error,
                         self.seed, self.max_retries)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size].tolist()
                for i in range(len(self))]

    def _iter_processes(self, batches) -> Iterator[Dict]:
        tag = self._epoch           # tells an abandoned epoch's results
        for bi, idxs in enumerate(batches):
            self._in_q.put((tag, bi, list(idxs)))
        pending: Dict[int, Dict] = {}
        nxt = 0
        while nxt < len(batches):
            while nxt not in pending:
                rtag, bi, item = self._out_q.get()
                if rtag == tag:
                    pending[bi] = item
            item = pending.pop(nxt)
            nxt += 1
            if isinstance(item, Exception):
                raise item
            yield item

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        self._epoch += 1
        if self.num_workers > 0:
            yield from self._iter_processes(batches)
            return
        if self.num_threads <= 1 and self.prefetch <= 1:
            for b in batches:
                yield collate([self._get(i) for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a consumer that abandons the iterator (max_iters) sets
            # `stop`; a plain q.put on a full queue would never see it
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if stop.is_set() or not put_or_stop(
                            collate([self._get(i) for i in b])):
                        return
            except Exception as e:  # surface loader errors to the consumer
                put_or_stop(e)
            finally:
                put_or_stop(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
