"""Batched, deterministically seeded data loader in threads or processes
(counterpart: ``gkgnet_tpu/data/loader.py``, a copy but for
``prefetch_to_device``).

Replaces torch DataLoader + mmcv collate (reference datasets/builder.py:
51-161). Per-sample RNG is ``default_rng((seed, epoch, position))``, so the
batches are bitwise the same for any worker count and either worker mode,
and bitwise the JAX package's loader's.

Two worker modes:
  * ``threads`` — PIL/numpy and the native ops release the GIL for the
    heavy parts; fine for eval-time resize/normalize.
  * ``processes`` — the full train augmentation stack (CropMixup multi-view
    blending, TrivialAugment PIL ops) is GIL-bound in pure-python glue, so
    the train path fans out to a spawn-based process pool, kept alive
    across epochs. A worker unpickles the dataset, which imports this
    package's data modules and native ops: none of them imports torch.

``prefetch_to_device`` keeps ``size`` batches in flight to the card: each
array is copied into pinned host memory and sent with ``non_blocking=True``.
"""

from __future__ import annotations

import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator

import numpy as np

from gkgnet_tpu_torch.data.samplers import DistributedSampler

_WORKER_DS = None


def _mp_init(ds_bytes: bytes):
    global _WORKER_DS
    _WORKER_DS = pickle.loads(ds_bytes)


def _mp_load(args):
    seed, epoch, pos, idx = args
    rng = np.random.default_rng((seed, epoch, pos))
    return _WORKER_DS.prepare_data(idx, rng)


def default_collate(samples: list[dict]) -> dict:
    batch: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            # uint8 passes through untouched: the device-normalize path
            # (pipelines.Normalize(device=True)) ships raw bytes to the
            # card — 4x less host->device traffic than fp32
            keep = vals[0].dtype in (np.int32, np.uint8)
            batch[key] = np.stack(vals).astype(
                vals[0].dtype if keep else np.float32)
        else:
            batch[key] = np.asarray(vals)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 4, collate_fn=default_collate,
                 mode: str = "threads"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else \
            DistributedSampler(dataset, 1, 0, shuffle=False, round_up=False)
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self.epoch = 0
        assert mode in ("threads", "processes"), mode
        self.mode = mode
        self._pool = None

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            # spawn: no inherited CUDA or thread state in workers
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context("spawn"),
                initializer=_mp_init,
                initargs=(pickle.dumps(self.dataset),))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_one(self, pos_idx):
        pos, idx = pos_idx
        rng = np.random.default_rng((self.seed, self.epoch, pos))
        return self.dataset.prepare_data(idx, rng)

    def __iter__(self) -> Iterator[dict]:
        indices = list(enumerate(self.sampler))
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                if self.mode == "processes":
                    pool = self._process_pool()  # persists across epochs
                    args = [(self.seed, self.epoch, pos, idx)
                            for pos, idx in indices]
                    stream = pool.map(_mp_load, args, chunksize=2)
                else:
                    pool = ThreadPoolExecutor(self.num_workers)
                    stream = pool.map(self._load_one, indices, chunksize=4)
                try:
                    batch_samples = []
                    for sample in stream:
                        if stop.is_set():
                            return
                        batch_samples.append(sample)
                        if len(batch_samples) == self.batch_size:
                            out_q.put(self.collate_fn(batch_samples))
                            batch_samples = []
                    if batch_samples and not self.drop_last:
                        out_q.put(self.collate_fn(batch_samples))
                finally:
                    if self.mode != "processes":
                        pool.shutdown(wait=False, cancel_futures=True)
            except BaseException as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 8,
                     num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                     sampler: str | None = None, seed: int = 0,
                     drop_last: bool = False,
                     mode: str = "threads") -> DataLoader:
    """mmcls build_dataloader semantics (builder.py:51-146): pick the
    sampler ('RepeatAugSampler' on the live train path, cfg:80), shard by
    rank. ``mode='processes'`` fans the augmentation stack out to a process
    pool (use for the train pipeline, which is GIL-bound under threads)."""
    from gkgnet_tpu_torch.data.samplers import IdInOrderSampler, RepeatAugSampler

    if sampler == "RepeatAugSampler":
        smp = RepeatAugSampler(dataset, num_replicas, rank, shuffle, seed=seed)
    elif sampler == "IdInOrder":
        smp = IdInOrderSampler(dataset, num_replicas, rank)
    else:
        smp = DistributedSampler(dataset, num_replicas, rank, shuffle,
                                 round_up=shuffle, seed=seed)
    return DataLoader(dataset, samples_per_gpu, smp, workers_per_gpu,
                      seed=seed, drop_last=drop_last, mode=mode)


def prefetch_to_device(iterator, device, size: int = 2):
    """Overlap host batch prep with the card's work: yields each batch as a
    dict of tensors on ``device`` while up to ``size`` later ones are being
    copied (from pinned host memory, ``non_blocking=True``)."""
    import collections

    import torch

    device = torch.device(device)

    def put(batch: dict) -> dict:
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
        return out

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
