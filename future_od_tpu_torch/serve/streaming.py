"""Streaming inference with a per-frame feature cache (port of
future_od_tpu/serve/streaming.py).

In the flagship every stage before the recurrent decoder (backbone, IMU
MLP, the per-frame encoder with egodeep) is a function of one frame, and
consecutive clips of a stream share all but one frame. So a server encodes
each frame once and keeps its features:

  batch inference: clip (f_{t-1}, f_t)     -> encode 2 frames + decode
  streaming:       new frame f_t arrives   -> encode 1 frame  + decode

The outputs are those of the batch path on the clip that ends at the new
frame: the cached tensors are the ones the batch path would recompute, and
the positions, the only offset-dependent piece, are recomputed per clip.
They differ from it only by the rounding of the other batch shape (B frames
folded against B·2).

Only a `FuturePredCore` without a joint encoder has that structure. The
JAX functions assume it without checking and serve a joint-encoder model
without its joint encoder; these functions refuse every other core.

The pair are modules (`EncodeFrame`, `DetectWindow`) that share the model's
submodules, so `serve/export.py` exports them as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from future_od_tpu_torch.models.cores import FuturePredCore, _positions
from future_od_tpu_torch.models.st_detr import normalize_outputs, post_process
from future_od_tpu_torch.ops.quant import assert_calibrated
from future_od_tpu_torch.parallel.mesh import (
    TENSOR_PARALLEL_ITEM,
    BatchSharding,
    gather_rows,
    module_replicas,
)
from future_od_tpu_torch.train.step import to_device_batch
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device


def streamable_core(model) -> FuturePredCore:
    """The model's core, when its forward is drop the future frame, encode
    each past frame alone, detect; raises ValueError otherwise."""
    core = model._model
    if not isinstance(core, FuturePredCore) or core.joint_encoder is not None:
        kind = type(core).__name__ + (" with a joint encoder" if isinstance(core, FuturePredCore)
                                      else "")
        raise ValueError(
            f"streaming serves a FuturePredCore without a joint encoder, not a {kind}: its "
            "outputs would differ from batch inference")
    return core


class EncodeFrame(nn.Module):
    """encode_frame(frame) -> (features (B, h, w, D), egodeep (B, D) or
    None): the separate encoder on ONE frame, {"video": (B, H, W, 3), IMU
    keys: (B, d)}, the IMU keys concatenated in `args.imu_keys()` order."""

    def __init__(self, model):
        super().__init__()
        self.separate_encoder = streamable_core(model).separate_encoder
        self.imu_keys = model.args.imu_keys()

    def forward(self, frame: Dict[str, torch.Tensor]):
        imu = None
        if frame.get("translation") is not None:
            imu = torch.cat([frame[k] for k in self.imu_keys], dim=1)[:, None]
        features, egodeep = self.separate_encoder(frame["video"][:, None], imu)
        return features[:, 0], (egodeep[:, 0] if egodeep is not None else None)


class DetectWindow(nn.Module):
    """detect_window(features, egodeep, temporal_offsets) -> the batch
    path's post-processed output dict, from the cached (B, L-1, h, w, D)
    window (egodeep (B, L-1, D) or None; the (B, L-1) offsets are read only
    under `encode_offset`). `clip_frames` is the L of the clip it emulates
    and `image_hw` the frames' pixels (default 32 x the feature map's)."""

    def __init__(self, model, clip_frames: int = 3,
                 image_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        core = streamable_core(model)
        self.detector = core.detector
        self.encode_offset = model.args.encode_offset
        self.no_temporal_pos = core.no_temporal_pos
        self.extra_temporal_offset = core.extra_temporal_offset
        self.clip_frames, self.image_hw = clip_frames, image_hw

    def forward(self, features, egodeep=None, temporal_offsets=None):
        B, _, h, w, _ = features.shape
        pos = _positions(features, temporal_offsets if self.encode_offset else None,
                         self.no_temporal_pos, self.extra_temporal_offset)
        out = self.detector(features, pos, egodeep)
        # post_process reads only the video's shape (pixel scale, frame
        # count): a zero-stride stand-in, no video-sized allocation
        H, W = self.image_hw if self.image_hw is not None else (h * 32, w * 32)
        data = {"video": torch.zeros((), dtype=features.dtype, device=features.device).expand(
            B, self.clip_frames, H, W, 3)}
        _, pred_logits, pred_boxes = normalize_outputs(out, data)
        return post_process(pred_logits, pred_boxes, data)[0]


def make_streaming_fns(model, clip_frames: int = 3,
                       image_hw: Optional[Tuple[int, int]] = None):
    """(encode_frame, detect_window) of a SpatioTemporalDETR whose core is a
    FuturePredCore without a joint encoder (ValueError for any other).
    clip_frames: the L of the batch clip this emulates (the decoder reads
    its L-1 past frames; the future frame is only a shape in
    post-processing). The model's weights are the pair's. A static-int8
    model must be calibrated first (ValueError)."""
    assert_calibrated(model)
    return EncodeFrame(model), DetectWindow(model, clip_frames, image_hw)


class StreamingSession:
    """Per-stream serving loop: feed frames, get per-clip outputs.

    Keeps the last `clip_frames - 1` encoded frames on the device. Each
    `step(frame)` encodes ONE new frame and, once the window is full,
    decodes: equal to batch inference on the clip ending at this frame.
    Runs on `device` (default CUDA; raises without a card), where the model
    must live, in inference mode.

    input_sharding: `parallel/mesh.py::batch_sharding(mesh)` spreads each
    frame batch's streams over the data axis of a mesh of this process's
    devices in contiguous blocks (B must divide by it), each block encoded
    and decoded on its device by a replica of the model, each device's
    window kept there; the outputs are the blocks' rows gathered, in order,
    on the mesh's first device. Every block is launched before any is read.
    """

    def __init__(self, model, clip_frames: int = 3, device: DeviceLike = None,
                 input_sharding: Optional[BatchSharding] = None):
        streamable_core(model)
        if input_sharding is None:
            devices = [resolve_device(device)]
        else:
            if not isinstance(input_sharding, BatchSharding):
                raise TypeError(f"input_sharding: want parallel.mesh.batch_sharding(mesh), got "
                                f"{input_sharding!r}")
            if input_sharding.mesh.shape["model"] != 1:
                raise NotImplementedError(TENSOR_PARALLEL_ITEM)
            devices = [resolve_device(d) for d in input_sharding.mesh.data_devices()]
        self.device = devices[0]
        self._devices = devices
        self._sharding = input_sharding
        self.window = clip_frames - 1
        replicas = module_replicas(model.eval(), devices)
        self._models = [replicas[d] for d in devices]
        self._clip_frames = clip_frames
        # the first device's (encode_frame, detect_window) and the other
        # devices', built on the first frame (they need H, W)
        self.encode = self.detect = None
        self._other_fns = []
        self._frames = []  # [(each device's (features, egodeep), offset)]

    def reset(self) -> None:
        self._frames = []

    def step(self, frame: Dict[str, torch.Tensor],
             temporal_offset: float = 0.0) -> Optional[Dict[str, torch.Tensor]]:
        """frame: {"video": (B, H, W, 3), IMU keys: (B, d)}, numpy or
        tensors. None until the window is full, then the output dict."""
        B = frame["video"].shape[0]
        blocks = [slice(0, B)] if self._sharding is None else self._sharding.blocks(B)
        if self.encode is None:
            hw = tuple(frame["video"].shape[1:3])
            fns = [make_streaming_fns(m, self._clip_frames, hw) for m in self._models]
            (self.encode, self.detect), self._other_fns = fns[0], fns[1:]
        pairs = [(self.encode, self.detect)] + self._other_fns
        with torch.inference_mode():
            encoded = [encode(to_device_batch({k: v[block] if hasattr(v, "shape") else v
                                               for k, v in frame.items()}, device))
                       for (encode, _), block, device in zip(pairs, blocks, self._devices)]
            self._frames = (self._frames + [(encoded, float(temporal_offset))])[-self.window:]
            if len(self._frames) < self.window:
                return None
            outs = [self._detect(c, detect) for c, (_, detect) in enumerate(pairs)]
        return gather_rows(outs, self.device)

    def _detect(self, c: int, detect) -> Dict[str, torch.Tensor]:
        """Device c's `detect` over its window."""
        window = [(enc[c], offset) for enc, offset in self._frames]
        features = torch.stack([f for (f, _), _ in window], dim=1)
        egos = [e for (_, e), _ in window]
        egodeep = None if egos[0] is None else torch.stack(egos, dim=1)
        offsets = torch.tensor([o for _, o in window], dtype=features.dtype,
                               device=features.device)[None].expand(features.shape[0],
                                                                    self.window)
        return detect(features, egodeep, offsets)
