"""Prefetching host loader (port of future_od_tpu/data/loader.py).

A thread pool loads samples (numpy's sample drawing and the heavy image work
release the interpreter lock), and batches are stacked into numpy arrays a
few batches ahead of the consumer. The Loader does not copy to the card: the
Trainer moves each batch with `train/step.py::to_device_batch`. Batch order
equals the JAX Loader's: the same numpy shuffles of the same seeds.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Sequence

import numpy as np

# Keys stacked into arrays; the rest (strings) stay lists.
ARRAY_KEYS = (
    "video", "boxes", "classes", "active", "annotated_frame_idx", "ignore_boxes",
    "translation", "acceleration", "rotation", "rotation_rate", "speed",
    "temporal_offsets",
)
VAL_SEED = 9069788369656784  # the reference's fixed validation seed (_loader.py:104)


def host_space_to_depth(video: np.ndarray) -> np.ndarray:
    """(..., H, W, C) -> (..., H/2, W/2, 4C): host-side 2x2 pixel packing in
    (di, dj, c) channel order. The pack layout must match
    models/resnet.py::space_to_depth (the on-device equivalent), the
    (4, 4, 12, 64) s2d stem kernel, and device_normalize's channel-tiled
    statistics. A video packed here feeds a `space_to_depth` model as it is,
    with no transpose on the device."""
    v = np.asarray(video)
    *lead, H, W, C = v.shape
    v = v.reshape(*lead, H // 2, 2, W // 2, 2, C)
    v = np.moveaxis(v, v.ndim - 4, v.ndim - 3)  # (..., H/2, W/2, di, dj, C)
    return np.ascontiguousarray(v).reshape(*lead, H // 2, W // 2, 4 * C)


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Samples -> one batch: the ARRAY_KEYS stacked, the rest as lists."""
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        if key in ARRAY_KEYS:
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
        else:
            batch[key] = [s[key] for s in samples]
    return batch


class Loader:
    """Iterable over numpy batches.

    Args:
        dataset: indexable with __len__/__getitem__ returning a sample dict.
        batch_size: batch size.
        shuffle: reshuffle every epoch, seeded by (seed, epoch) for
            determinism (the DistributedSampler.set_epoch idiom).
        seed: the shuffle's seed (VAL_SEED for the validation order).
        drop_last: drop the trailing partial batch.
        num_workers: host threads that load samples.
        prefetch: batches loaded ahead of the consumer.
        space_to_depth: pack each sample's video 2x2 into 12 channels on the
            host (`host_space_to_depth`), for a `space_to_depth` model.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        space_to_depth: bool = False,
    ):
        if len(dataset) == 0:
            raise ValueError("All loaders must be non-empty")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.space_to_depth = space_to_depth
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed * 100_003 + self._epoch) % (2**63)).shuffle(order)
        else:
            np.random.default_rng(self.seed % (2**63)).shuffle(order)
        for b in range(len(self)):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # fan out per sample, so one batch's samples fill every
                    # worker; `pending` holds the ordered sample futures of up
                    # to prefetch + 1 batches
                    pending = []

                    def drain(futs):
                        out_q.put(("ok", collate([f.result() for f in futs])))

                    try:
                        for idxs in self._batch_indices():
                            if stop.is_set():
                                return
                            pending.append([pool.submit(self._get_sample, i) for i in idxs])
                            while len(pending) > self.prefetch:
                                drain(pending.pop(0))
                        while pending and not stop.is_set():
                            drain(pending.pop(0))
                    finally:
                        # early exit (the consumer stopped, or an error): drop
                        # the queued work so the pool shuts down promptly
                        for futs in pending:
                            for f in futs:
                                f.cancel()
            except Exception as exc:  # handed to the consumer, which raises it
                out_q.put(("err", exc))
            finally:
                out_q.put(("done", None))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, so it sees `stop`
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def _get_sample(self, i):
        sample = self.dataset[i]
        if self.space_to_depth:
            sample = dict(sample)
            sample["video"] = host_space_to_depth(sample["video"])
        return sample
