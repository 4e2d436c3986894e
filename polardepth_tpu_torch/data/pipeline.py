"""Host -> device input pipeline: batching, shuffling, the sample cache, and
the prefetch onto the card (polardepth_tpu/data/pipeline.py).

Host work is PNG decode and stacking only; batches are uint8/uint16-heavy
and small.  ``BatchIterator`` is numpy only and yields the same batches in
the same order as the JAX package's.  ``device_prefetch`` copies each batch
from pinned memory to the card on a side CUDA stream while the current step
computes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class BatchIterator:
    """Yields stacked numpy batch dicts from an indexable sample source.

    drop_last=True always (static shapes; reference uses drop_last=True for
    all three loaders, trainer.py:281-303).

    Checkpointable: the shuffle order is a pure function of (seed, epoch) and
    the position within the epoch is tracked in `cursor`, so `state()` /
    `set_state()` make mid-epoch resume exact — a restored iterator yields
    the identical remaining batch sequence (the reference's torch DataLoader
    cannot do this; its resume granularity is the epoch, SURVEY §5).
    `cursor` advances when a batch is handed to the consumer, i.e. a snapshot
    taken after training on batch b resumes at b+1.  Snapshot only between
    steps with no async prefetch in flight (the Trainer path satisfies this).
    """

    def __init__(self, load_fn: Callable[[int], dict], num_samples: int,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 8, array_keys: Optional[Sequence[str]] = None,
                 cache_bytes: int = 0, shard_index: int = 0,
                 num_shards: int = 1):
        # shard_index/num_shards: multi-process data loading; each process
        # yields only its interleaved slice of every global batch (the
        # shuffle order is a pure function of (seed, epoch), so shards are
        # consistent and disjoint with no coordination).  batch_size is the
        # global batch size; local batches carry batch_size / num_shards
        # samples.
        if batch_size % num_shards:
            raise ValueError(f"global batch_size {batch_size} must divide "
                             f"evenly over {num_shards} process shards")
        self.load_fn = load_fn
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.array_keys = array_keys
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0
        self.cursor = 0
        self._resume_pending = False
        # Decoded-sample RAM cache: samples ship raw uint8/uint16 (all float
        # work is on the device), so whole corpora fit host RAM and epochs
        # 2+ skip the PNG decode.  0 disables.
        self._cache_bytes = cache_bytes
        self._cache: dict[int, dict] = {}
        self._cache_used = 0
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return self.num_samples // self.batch_size

    def state(self) -> dict:
        """Snapshot for checkpointing (plain ints)."""
        return {"seed": int(self.seed), "epoch": int(self.epoch),
                "cursor": int(self.cursor)}

    def set_state(self, state: dict) -> None:
        """Arm an exact resume: the next __iter__ starts at the snapshot's
        (epoch, cursor) instead of the top of an epoch.  A snapshot taken
        after an epoch's last batch, before its pass ended, resumes at the
        top of the next epoch."""
        if int(state["seed"]) != int(self.seed):
            raise ValueError(
                f"iterator seed mismatch: checkpoint {state['seed']} vs "
                f"configured {self.seed}")
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        if self.cursor >= len(self):
            self.epoch, self.cursor = self.epoch + 1, 0
        self._resume_pending = True

    def _order(self) -> np.ndarray:
        order = np.arange(self.num_samples)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order

    def _stack(self, samples: list[dict]) -> dict:
        keys = self.array_keys or [
            k for k, v in samples[0].items() if isinstance(v, np.ndarray)]
        return {k: np.stack([s[k] for s in samples]) for k in keys}

    def __iter__(self) -> Iterator[dict]:
        # A fresh pass starts at batch 0 unless set_state() just armed an
        # exact resume — so abandoned partial passes (e.g. a single-batch
        # validation pull) cannot shift later epochs.
        start = self.cursor if self._resume_pending else 0
        self._resume_pending = False
        self.cursor = start
        order = self._order()
        n_batches = len(self)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(start, n_batches):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                if self.num_shards > 1:  # this process's slice of the batch
                    idxs = idxs[self.shard_index::self.num_shards]
                samples = list(pool.map(self._load_cached, idxs))
                self.cursor = b + 1
                yield self._stack(samples)
        self.epoch += 1
        self.cursor = 0

    def _load_cached(self, i) -> dict:
        i = int(i)
        if self._cache_bytes:
            hit = self._cache.get(i)
            if hit is not None:
                return hit
        sample = self.load_fn(i)
        if self._cache_bytes:
            size = sum(v.nbytes for v in sample.values()
                       if isinstance(v, np.ndarray))
            with self._cache_lock:
                if i not in self._cache and \
                        self._cache_used + size <= self._cache_bytes:
                    self._cache[i] = sample
                    self._cache_used += size
        return sample


def _pinned(x) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.pin_memory() if t.device.type == "cpu" else t


def device_prefetch(it: Iterator[dict], device="cuda",
                    size: int = 2) -> Iterator[dict]:
    """Move batches to device ahead of their use (double buffering).

    On a card, a producer thread copies each batch from pinned host memory
    on a side CUDA stream and records an event; the consumer's stream waits
    on that event, and each tensor is marked as used by the consumer's
    stream (record_stream), so that the allocator never hands out a buffer
    whose copy is still in flight.  For the CPU the batch becomes tensors.
    An error in the producer (a decode error, an out-of-memory) is raised
    in the consumer: a loader error aborts the epoch instead of truncating
    it.
    """
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)

    def put(batch: dict):
        if stream is None:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: _pinned(v).to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def producer():
        try:
            for batch in it:
                q.put(put(batch))
        except BaseException as exc:  # noqa: BLE001 - raised below
            q.put((end, exc))
            return
        q.put((end, None))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        batch, done = q.get()
        if batch is end:
            if done is not None:
                raise done
            return
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        yield batch
