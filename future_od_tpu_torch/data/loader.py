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
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from future_od_tpu_torch.parallel.mesh import split_rows

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
        shard: (rank, world) of a data-parallel run: every rank walks the
            same global batch order (same seed and epoch) and loads only its
            contiguous block of each batch's rows, so no rank loads another
            rank's samples. `len` and `batch_size` stay global. A ragged
            batch (rows % world != 0, kept by drop_last=False) splits
            unevenly, the first ranks one row more; a rank whose block is
            empty gets None in that batch's place.
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
        shard: Optional[Tuple[int, int]] = None,
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
        self.shard = shard
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

    def _rank_batches(self):
        """The sample indices this process loads, batch by batch: the
        global batches, or under `shard` this rank's block of each."""
        if self.shard is None:
            yield from self._batch_indices()
            return
        rank, world = self.shard
        for idxs in self._batch_indices():
            yield idxs[split_rows(len(idxs), world)[rank]]

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
                        out_q.put(("ok", collate([f.result() for f in futs]) if futs else None))

                    try:
                        for idxs in self._rank_batches():
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


class _Samples:
    """The map-style dataset a DataLoader worker indexes: the Loader's own
    sample path (with its host space-to-depth packing)."""

    def __init__(self, loader: "Loader"):
        self.dataset, self.space_to_depth = loader.dataset, loader.space_to_depth

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        sample = self.dataset[int(i)]
        if self.space_to_depth:
            sample = dict(sample, video=host_space_to_depth(sample["video"]))
        return sample


class _Order:
    """The sampler of a WorkerLoader's DataLoader: the Loader's batches for
    its current epoch, flattened, read anew at every pass. It holds the
    loader weakly, so that dropping the loader frees the DataLoader and
    stops its workers at once (a cycle would wait for the collector)."""

    def __init__(self, loader: "Loader"):
        self.loader = weakref.proxy(loader)

    def __iter__(self):
        return (int(i) for b in self.loader._rank_batches() for i in b)

    def __len__(self):
        return sum(len(b) for b in self.loader._rank_batches())


def _as_is(sample):
    return sample


class WorkerLoader(Loader):
    """The Loader's contract over worker processes (`--loader grain`, in
    place of the JAX package's grain loader), for datasets whose Python work
    holds the interpreter lock: a torch.utils.data.DataLoader whose
    `num_workers` processes load samples one at a time, in the Loader's
    order for its seed and epoch, a few batches ahead; this process stacks
    them into the Loader's batches. Each worker draws its own augmentations,
    as the thread Loader's threads share theirs. The workers are spawned
    (not forked: the trainer's process runs threads) at the first pass and
    kept for the later ones."""

    def __init__(self, dataset, *args, **kwargs):
        super().__init__(dataset, *args, **kwargs)
        self._loader = None

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self._loader is None:
            from torch.utils.data import DataLoader

            workers = self.num_workers if len(self.dataset) > 1 else 0
            ahead = -(-self.prefetch * self.batch_size // max(workers, 1))
            self._loader = DataLoader(
                _Samples(self), sampler=_Order(self), batch_size=None, collate_fn=_as_is,
                num_workers=workers, prefetch_factor=ahead if workers else None,
                persistent_workers=workers > 0,
                multiprocessing_context="spawn" if workers else None)
        samples = iter(self._loader)
        for idxs in self._rank_batches():
            yield collate([next(samples) for _ in idxs]) if len(idxs) else None
