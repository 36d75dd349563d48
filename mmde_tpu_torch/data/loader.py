"""Batching, prefetching loader and host-to-device pipeline.

Counterpart of mmde_tpu/data/loader.py: `collate`, `DataLoader` (a thread
pool runs the dataset's __getitem__ ahead of time; the epoch's order is
`np.random.default_rng(seed)`'s shuffle, so the two packages give the same
batches for the same seed) and `device_prefetch`, which moves batches to
the device ahead of the step that consumes them.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence, Union

import numpy as np
import torch

_SKIP_STACK_TYPES = (str, bytes)


def collate(items: Sequence[dict]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict. String fields
    become lists (file names); numeric fields are stacked on axis 0."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], _SKIP_STACK_TYPES):
            out[key] = list(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Epoch-based loader: shuffle, parallel __getitem__, collate.

    Args:
        dataset: any object with __len__ / __getitem__ returning sample dicts.
        batch_size: samples per batch.
        shuffle: reshuffle the indices each epoch.
        num_workers: threads running __getitem__ (0 = synchronous).
        drop_last: drop the trailing partial batch.
        prefetch: batches queued ahead.
        seed: the shuffle's generator.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = max(prefetch, 1)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[np.ndarray]:
        """The next epoch's batches of sample indices (shuffling advances
        the generator, as the JAX package's loader does)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for batch_idx in self._index_batches():
                yield collate([self.dataset[int(i)] for i in batch_idx])
            return

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            gen = self._index_batches()

            def submit(batch_idx):
                pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in batch_idx])

            for _ in range(self.prefetch):
                nxt = next(gen, None)
                if nxt is None:
                    break
                submit(nxt)

            while pending:
                futures = pending.pop(0)
                nxt = next(gen, None)
                if nxt is not None:
                    submit(nxt)
                yield collate([f.result() for f in futures])


def _to_device(arrays: Dict[str, np.ndarray], device: torch.device,
               stream) -> Dict[str, torch.Tensor]:
    """Copy numpy arrays to `device`: on CUDA from pinned host memory with
    non-blocking copies enqueued on `stream`; on the CPU as tensors sharing
    the arrays' memory. uint8 arrays stay uint8 (the step normalises them
    on the device)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in arrays.items()}
    out = {}
    with torch.cuda.stream(stream):
        for k, v in arrays.items():
            host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            out[k] = host.to(device, non_blocking=True)
    return out


def device_prefetch(iterator, device: Union[str, torch.device] = "cuda",
                    size: int = 2) -> Iterator[dict]:
    """Move batches to `device` ahead of consumption: a producer thread
    runs `iterator` and copies each batch's arrays (non-array fields pass
    through), up to `size` batches ahead.

    On CUDA the copies are enqueued from pinned host memory on a side
    stream, each batch followed by an event; the consumer's current stream
    waits on that event before the batch is handed out, and each tensor is
    marked with `record_stream` so that the caching allocator does not hand
    its memory to another tensor while work of the consumer's stream may
    still read it. On the CPU the tensors share the arrays' memory."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_prefetch: device is CUDA but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()
    failed = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                arrays = {k: v for k, v in batch.items()
                          if isinstance(v, np.ndarray)}
                rest = {k: v for k, v in batch.items()
                        if not isinstance(v, np.ndarray)}
                tensors = _to_device(arrays, device, stream)
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                if not put((tensors, rest, event)):
                    break
        except Exception as e:          # handed to the consumer, re-raised
            failed.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            tensors, rest, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in tensors.values():
                    v.record_stream(consumer)
            tensors.update(rest)
            yield tensors
        if failed:
            raise failed[0]
    finally:
        # a consumer that stops early (a step cap) ends the producer too
        stop.set()
        t.join(timeout=60)
