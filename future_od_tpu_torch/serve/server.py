"""Multi-stream serving (port of future_od_tpu/serve/server.py): many
asynchronous video streams micro-batched onto one card with fixed-shape
batches and device-resident feature rings.

`StreamingSession` (serve/streaming.py) serves ONE lockstep batch of
streams. Production serving has N cameras whose frames arrive on their own,
and streams that join and leave. The design keeps the JAX package's:
- each encoded frame's features live in a preallocated ring on the card;
  the host keeps only integer slot bookkeeping;
- `_encode_store`: encode a fixed (B, H, W, 3) frame batch and write the
  features into their ring slots in place (`index_copy_`);
- `_detect_gather`: gather the (B, window) slot windows from the ring and
  run the recurrent decoder and the post-processing;
- a dispatch takes at most ONE frame a stream, so a clip's window slots are
  never overwritten within the dispatch that detects them;
- a partial batch is padded; no op mixes batch rows, so padding cannot leak
  into real rows (tests/test_torch_server.py holds a stream served alone
  bit for bit against the same stream sharing its batch). Pad rows write to
  a scratch ring slot.
- over a mesh (`mesh=`, `parallel/mesh.py`), streams are pinned to the
  least-loaded device of its data axis, and each device owns a contiguous
  shard of the ring (its own tensor, on the device) and max_batch/K rows of
  every dispatch, with a replica of the model; every ring write and read
  stays on the stream's device. A dispatch launches every device's share
  before it reads any, so the cards work at once. A grid may list one
  device twice (both shares then run on it, with one replica).

Results come back BATCHED: each dispatch yields `(placements, outputs)`,
`placements` mapping stream ids to rows of `outputs` (a post-processed dict
with a leading batch dim, left on the card; over a mesh, the devices' rows
gathered on its first device), so one sync reads every clip of a dispatch. `split_results` unpacks them into per-stream dicts.
`stats()` reports how much of the dispatched rows was padding.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from future_od_tpu_torch.models.st_detr import IMU_WIDTHS
from future_od_tpu_torch.parallel.mesh import TENSOR_PARALLEL_ITEM, gather_rows, module_replicas
from future_od_tpu_torch.serve.streaming import make_streaming_fns, streamable_core
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device

IMU_KEYS = tuple(IMU_WIDTHS)  # every IMU key a frame carries

Placement = Tuple[Hashable, int]  # (stream id, row in the batched outputs)
Results = List[Tuple[Tuple[Placement, ...], Dict[str, torch.Tensor]]]


def split_results(results: Results) -> List[Tuple[Hashable, Dict[str, torch.Tensor]]]:
    """Unpack batched dispatch results into per-stream output dicts."""
    return [(sid, {k: v[row] for k, v in batched.items()})
            for placements, batched in results for sid, row in placements]


def _stack(rows, device: torch.device) -> torch.Tensor:
    """Stack frame rows into a batch on `device`: numpy rows stack on the
    host, then ONE copy to the device; tensors stack where they are."""
    if all(isinstance(r, np.ndarray) for r in rows):
        return torch.as_tensor(np.stack(rows), device=device)
    return torch.stack([torch.as_tensor(r, device=device) for r in rows])


class _StreamState:
    __slots__ = ("chip", "base", "seen", "offsets", "queue")

    def __init__(self, chip: int, base: int, window: int):
        self.chip = chip  # owning chip (place on the mesh's data axis); 0 without one
        self.base = base  # first slot of this stream's region in its chip's ring
        self.seen = 0  # frames encoded so far
        self.offsets: deque = deque(maxlen=window)  # temporal offsets
        self.queue: deque = deque()  # frames waiting for a dispatch slot


class _Chip:
    __slots__ = ("free", "order")

    def __init__(self, streams_per_chip: int):
        self.free = list(range(streams_per_chip - 1, -1, -1))
        self.order: deque = deque()  # sids with queued frames, FIFO


class MultiStreamServer:
    """Serve many independent video streams with fixed-shape micro-batches.

    Args:
        model: a SpatioTemporalDETR whose core is a FuturePredCore without
            a joint encoder (cast it to bf16 first to serve in bf16); it
            must live on `device` (over a mesh: anywhere; each device of
            the mesh gets a replica).
        max_batch: the fixed batch of every dispatch.
        clip_frames: L of the batch clip being emulated (the decoder reads
            L-1 past frames).
        max_streams: ring capacity in streams; `close_stream` frees a slot.
        mesh: a `parallel/mesh.py` mesh of this process's devices, whose
            data axis the streams spread over (module docstring); its model
            axis must be 1, and max_batch and max_streams must divide by its
            data axis.
        device: without a mesh, default CUDA (raises without a card).
    """

    def __init__(self, model, max_batch: int, clip_frames: int = 3, max_streams: int = 64,
                 mesh=None, device: DeviceLike = None):
        streamable_core(model)
        self.max_batch = int(max_batch)
        self.window = clip_frames - 1
        self.max_streams = int(max_streams)
        self._clip_frames = clip_frames
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            if mesh.shape["model"] != 1:
                raise NotImplementedError(TENSOR_PARALLEL_ITEM)
            devices = [resolve_device(d) for d in mesh.data_devices()]
            if self.max_batch % len(devices) or self.max_streams % len(devices):
                raise ValueError(f"max_batch {self.max_batch} and max_streams "
                                 f"{self.max_streams} must divide by the data axis "
                                 f"{len(devices)}")
        self.mesh = mesh
        self.device = devices[0]  # where a dispatch's outputs are gathered
        self._devices = devices  # each chip's device
        replicas = module_replicas(model.eval(), devices)
        self._models = [replicas[d] for d in devices]
        self._num_chips = len(devices)
        self._batch_local = self.max_batch // self._num_chips
        self._streams_local = self.max_streams // self._num_chips
        self._slots_per_stream = self.window + 1  # +1: the in-flight write
        # a chip's ring shard: stream regions + one scratch slot (pad rows)
        self._ring_local = self._streams_local * self._slots_per_stream + 1
        self._scratch = self._ring_local - 1
        self._chips = [_Chip(self._streams_local) for _ in range(self._num_chips)]
        self._streams: Dict[Hashable, _StreamState] = {}
        self._fns = None  # each chip's (encode_frame, detect_window)
        self._ring = None  # each chip's (ring_local, h, w, D), the features' dtype
        self._ego_ring = None  # each chip's (ring_local, D), or None without egodeep
        self._has_imu: Optional[bool] = None
        self._dispatches = 0
        self._padded_rows = 0
        self._real_rows = 0

    # -- lifecycle ---------------------------------------------------------

    def close_stream(self, stream_id: Hashable) -> None:
        """Forget a stream's cached window (frames still queued are dropped)."""
        state = self._streams.pop(stream_id, None)
        if state is None:
            return
        chip = self._chips[state.chip]
        chip.free.append(state.base // self._slots_per_stream)
        if stream_id in chip.order:
            chip.order.remove(stream_id)

    def stats(self) -> Dict[str, float]:
        rows = self._real_rows + self._padded_rows
        return {
            "dispatches": self._dispatches,
            "frames": self._real_rows,
            "pad_fraction": (self._padded_rows / rows) if rows else 0.0,
            "active_streams": len(self._streams),
        }

    def ring_bytes(self) -> int:
        """Device bytes the feature and egodeep rings hold (0 before the
        first dispatch)."""
        rings = [r for chips in (self._ring, self._ego_ring) if chips is not None for r in chips]
        return sum(r.numel() * r.element_size() for r in rings)

    # -- ingestion ---------------------------------------------------------

    def submit(self, stream_id: Hashable, frame: Dict[str, Any],
               temporal_offset: float = 0.0) -> Results:
        """Queue one frame ((H, W, 3) video + per-key (d,) IMU) for a stream.

        Returns batched results of any dispatch this submit triggered (empty
        while batches are filling). A dispatch fires when some chip has
        max_batch/num_chips DISTINCT streams with frames queued: one frame
        a stream a dispatch, so a flooding stream queues instead of starving
        others."""
        frame_has_imu = frame.get("translation") is not None
        if self._has_imu is None:
            self._has_imu = frame_has_imu
        elif frame_has_imu != self._has_imu:
            # fail BEFORE any bookkeeping mutates: a mixed fleet would
            # otherwise drop a stream's IMU or fail mid-dispatch after the
            # queues were popped
            raise ValueError(
                f"stream {stream_id!r} {'has' if frame_has_imu else 'lacks'} "
                f"IMU but this server was opened "
                f"{'with' if self._has_imu else 'without'} IMU; all streams "
                "must agree (the encode takes one set of inputs)"
            )
        state = self._streams.get(stream_id)
        if state is None:
            # pin new streams to the least-loaded chip with free capacity
            candidates = [c for c in range(self._num_chips) if self._chips[c].free]
            if not candidates:
                raise RuntimeError(
                    f"more than max_streams={self.max_streams} active "
                    "streams; close_stream() finished ones or raise the cap"
                )
            chip_id = max(candidates, key=lambda c: len(self._chips[c].free))
            base = self._chips[chip_id].free.pop() * self._slots_per_stream
            state = _StreamState(chip_id, base, self.window)
            self._streams[stream_id] = state
        state.queue.append((frame, float(temporal_offset)))
        chip = self._chips[state.chip]
        if stream_id not in chip.order:
            chip.order.append(stream_id)
        results = []
        while any(len(c.order) >= self._batch_local for c in self._chips):
            results.extend(self._dispatch_round())
        return results

    def flush(self) -> Results:
        """Dispatch everything pending (padding partial batches)."""
        results = []
        while any(c.order for c in self._chips):
            results.extend(self._dispatch_round())
        return results

    # -- dispatch ----------------------------------------------------------

    def _encode_store(self, c: int, video, imu, slots) -> None:
        """Encode chip c's frame batch and write its features into `slots`
        of the chip's rings, in place; the rings are made at the first
        call, in the features' dtype."""
        batch = {"video": video}
        if imu is not None:
            batch.update(imu)
        feats, ego = self._fns[c][0](batch)
        if self._ring is None:
            self._ring = [feats.new_zeros((self._ring_local,) + feats.shape[1:], device=d)
                          for d in self._devices]
            if ego is not None:
                self._ego_ring = [ego.new_zeros((self._ring_local,) + ego.shape[1:], device=d)
                                  for d in self._devices]
        self._ring[c].index_copy_(0, slots, feats)
        if ego is not None:
            self._ego_ring[c].index_copy_(0, slots, ego)

    def _detect_gather(self, c: int, idx, offsets):
        """The decoder and post-processing over chip c's (B_local, window)
        ring slots `idx`."""
        ego = self._ego_ring[c][idx] if self._ego_ring is not None else None
        return self._fns[c][1](self._ring[c][idx], ego, offsets)

    def _dispatch_round(self) -> Results:
        """Encode one frame from up to batch_local streams PER CHIP, then
        detect every clip that completed."""
        # -- gather work, grouped by chip (row block c*B_local..(c+1)*B_local)
        work: List[Optional[Tuple[Hashable, Dict[str, Any], float]]] = []
        any_work = False
        for chip in self._chips:
            taken: set = set()
            # at most ONE frame per stream per round (the ring-slot safety
            # invariant): a re-appended sid waits for the next round
            while (
                chip.order
                and len(taken) < self._batch_local
                and chip.order[0] not in taken
            ):
                sid = chip.order.popleft()
                taken.add(sid)
                state = self._streams[sid]
                frame, offset = state.queue.popleft()
                work.append((sid, frame, offset))
                if state.queue:
                    chip.order.append(sid)  # more frames -> next round
            any_work = any_work or bool(taken)
            work.extend([None] * (self._batch_local - len(taken)))
        if not any_work:
            return []
        if self._fns is None:
            hw = tuple(next(w for w in work if w)[1]["video"].shape[:2])
            self._fns = [make_streaming_fns(m, self._clip_frames, hw) for m in self._models]

        # -- assemble each chip's fixed-shape frame batch; pad rows reuse any
        # real frame (rows never mix; pad features land in the chip's
        # scratch slot)
        fallback = next(w for w in work if w)[1]
        slots, ready = [], []
        for c in range(self._num_chips):
            for j in range(self._batch_local):
                w = work[c * self._batch_local + j]
                if w is None:
                    slots.append(self._scratch)
                    continue
                sid, _, offset = w
                state = self._streams[sid]
                slots.append(state.base + state.seen % self._slots_per_stream)
                state.seen += 1
                state.offsets.append(offset)
                if state.seen >= self.window:
                    # window = the last `window` slots, oldest first
                    idx = [state.base + k % self._slots_per_stream
                           for k in range(state.seen - self.window, state.seen)]
                    ready.append((sid, idx, list(state.offsets)))
        with torch.inference_mode():
            for c, device in enumerate(self._devices):  # every chip's share, no sync between
                block = slice(c * self._batch_local, (c + 1) * self._batch_local)
                rows = [w[1] if w else fallback for w in work[block]]
                video = _stack([r["video"] for r in rows], device)
                imu = ({k: _stack([r[k] for r in rows], device) for k in IMU_KEYS}
                       if self._has_imu else None)
                self._encode_store(c, video, imu, torch.as_tensor(slots[block], device=device))
        self._dispatches += 1
        n_real = sum(1 for w in work if w)
        self._real_rows += n_real
        self._padded_rows += len(work) - n_real

        # -- detect: group completed clips by owning chip into row blocks
        results = []
        per_chip = [[] for _ in range(self._num_chips)]
        for clip in ready:
            per_chip[self._streams[clip[0]].chip].append(clip)
        while any(per_chip):
            placements, outs = [], []
            for c, device in enumerate(self._devices):
                batch_c = per_chip[c][: self._batch_local]
                per_chip[c] = per_chip[c][self._batch_local:]
                idx, offs = [], []
                for j, (sid, slot_idx, offsets) in enumerate(batch_c):
                    placements.append((sid, c * self._batch_local + j))
                    idx.append(slot_idx)
                    offs.append(offsets)
                pad = self._batch_local - len(batch_c)
                idx.extend([[self._scratch] * self.window] * pad)
                offs.extend([[0.0] * self.window] * pad)
                with torch.inference_mode():
                    outs.append(self._detect_gather(
                        c, torch.as_tensor(idx, device=device),
                        torch.as_tensor(np.asarray(offs, np.float32), device=device).to(
                            self._ring[c].dtype)))
            results.append((tuple(placements), gather_rows(outs, self.device)))
        return results
