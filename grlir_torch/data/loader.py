"""Host-side batch loader: prefetching producers of fixed-shape numpy
batches (the port's copy of `grlir.data.loader`, with its index shuffling,
drop_last, sharding arguments and per-batch reseeding, so that one seed
gives grlir's batch stream).

Two backends behind one API:

- ``worker_mode="thread"`` (default): a thread pool; numpy and zlib release
  the interpreter lock while they decode and crop.
- ``worker_mode="process"``: a spawn-context process pool for pipelines
  bound by the interpreter lock.  Each worker unpickles the dataset once
  (initializer) and collates whole batches, so only the final batch dict
  crosses the pipe.

Batches are dicts of stacked numpy arrays; the trainer moves them to the
device.  String fields are kept as lists.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def _collate(samples: List[dict]) -> dict:
    out: Dict[str, object] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


# ---- process-worker plumbing (worker_mode="process") -----------------------
# Spawn context: the parent holds an initialized CUDA runtime and threads,
# and fork is unsafe there.  The dataset is pickled once and shipped via the
# pool initializer; workers hold their own copy + de-correlated rng.
_WORKER_DS = None


def _worker_init(pickled_dataset, base_seed, counter):
    global _WORKER_DS
    import pickle

    _WORKER_DS = pickle.loads(pickled_dataset)
    # de-correlate stochastic pipelines across workers (each process got an
    # identical pickled rng state).  torch-style deterministic seeding:
    # base_seed + worker_id — pid-keyed seeds made runs irreproducible and
    # could collide across hosts (pids are per-host namespaces); base_seed is
    # the loader's _pipeline_seed, which mixes in the host rank.
    with counter.get_lock():
        worker_id = counter.value
        counter.value += 1
    if hasattr(_WORKER_DS, "seed"):
        _WORKER_DS.seed((base_seed + worker_id) % (2**31))


def _worker_fetch(idxs, batch_seed=None):
    # per-BATCH reseeding: which worker serves which batch is scheduler-
    # dependent, so worker-keyed rng alone cannot make runs reproducible.
    # Seeding by batch serial makes the stream deterministic regardless of
    # scheduling AND of num_workers (stronger than torch's per-worker
    # semantics, which change results with the worker count).
    if batch_seed is not None and hasattr(_WORKER_DS, "seed"):
        _WORKER_DS.seed(batch_seed)
    return _collate([_WORKER_DS[i] for i in idxs])


class DataLoader:
    """Minimal epoch-based loader: shuffle, drop_last, threaded map, prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 2,
        prefetch: int = 4,
        seed: int = 0,
        shard: tuple = (0, 1),
        worker_mode: str = "thread",
    ):
        """shard=(process_index, process_count): each host reads its stride of
        the (shared-seed) shuffled order — the DistributedSampler analogue; val
        overlap/padding is neutralized downstream by dedup-by-index
        (metrics/collect.py).

        worker_mode: "thread" | "process" — see module docstring.  The process
        pool is created lazily on first iteration and reused across epochs
        (infinite() streams don't pay respawn cost per epoch)."""
        assert worker_mode in ("thread", "process"), worker_mode
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.shard = shard
        self.worker_mode = worker_mode
        self._epoch = 0
        self._batch_serial = 0  # per-batch reseed counter (process mode)
        self._pool = None
        # Stochastic-pipeline seed, de-correlated across hosts: the SHUFFLE
        # seed must stay identical on every host (rank-stride sharding of one
        # shared order), but degradation/ISP parameter streams must NOT —
        # otherwise every host replays the same random-parameter sequence on
        # its shard.  100003 is prime and far from
        # the 7919 batch-serial stride.
        self._pipeline_seed = (seed + 100003 * shard[0]) % (2**31)

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            import pickle

            ctx = mp.get_context("spawn")
            counter = ctx.Value("i", 0)
            self._pool = ctx.Pool(
                self.num_workers,
                initializer=_worker_init,
                initargs=(pickle.dumps(self.dataset), self._pipeline_seed,
                          counter),
            )
        return self._pool

    def close(self):
        """Tear down the process pool (no-op in thread mode)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _index_batches(self) -> List[List[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        rank, world = self.shard
        if world > 1:
            order = order[rank::world]
        batches = [
            order[i: i + self.batch_size].tolist()
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[dict]:
        if self.worker_mode == "process":
            yield from self._iter_process()
            return
        batches = self._index_batches()
        # thread mode shares ONE in-process dataset rng; on multi-host runs
        # reseed it per (host, epoch) so degradation parameter streams differ
        # across hosts (process mode handles this via _pipeline_seed instead)
        if self.shard[1] > 1 and hasattr(self.dataset, "seed"):
            self.dataset.seed((self._pipeline_seed + 104729 * self._epoch)
                              % (2**31))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        END = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        q.put(_collate(samples))
                q.put(END)
            except Exception as e:  # raised again in the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_process(self) -> Iterator[dict]:
        """Process-pool epoch: keep `prefetch` whole-batch fetches in flight,
        yield strictly in order (torch DataLoader reordering semantics)."""
        pool = self._process_pool()
        batches = self._index_batches()
        inflight: "queue.Queue" = queue.Queue()
        depth = max(1, self.prefetch)
        it = iter(batches)

        def submit_next():
            idxs = next(it, None)
            if idxs is not None:
                bs = (self._pipeline_seed + 7919 * self._batch_serial) % (2**31)
                self._batch_serial += 1
                inflight.put(pool.apply_async(_worker_fetch, (idxs, bs)))

        for _ in range(depth):
            submit_next()
        while not inflight.empty():
            result = inflight.get()
            submit_next()
            # .get() re-raises worker exceptions in the consumer
            yield result.get()

    def infinite(self) -> Iterator[dict]:
        """Endless stream for step-based training (the reference converts steps
        into a virtual epoch; this cycles the epochs)."""
        epoch = 0
        while True:
            self.set_epoch(epoch)
            yield from self
            epoch += 1
