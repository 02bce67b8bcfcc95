"""Export of serving programs (port of future_od_tpu/serve/export.py, with
`torch.export` in the place of `jax.export`).

An artifact is a sealed program: a serving host reloads it with
`load_serving` without the model-building code on its path. What it needs
at load is torch and the port's op registrations
(`future_od_tpu_torch/ops/flash_attention.py`, `ops/fused_resnet.py`,
`ops/int8_conv.py` and `ops/int8_quantize.py`, which `load_serving`
imports): the kernels K1-K3, K8 and K9 stay in the graph as the ops
`fod::flash_attention`, `fod::fused_bottleneck`, `fod::fused_stem`,
`fod::int8_conv`, `fod::int8_channel_range` and `fod::int8_quantize`, as the
Pallas kernels stay in the JAX artifact. An int8 model's smoothing and
weight quantization are the graph's own ops, and a static-int8 model's
ranges travel in its state. The gates set at export
time (`FUTURE_OD_FLASH_*`, `FUTURE_OD_FUSED_*`) are fixed in the artifact,
which launches the kernels the eager call launches under them; the fused
blocks' packed weights are computed in the graph from the weights at every
call.

Two serving surfaces are exportable:
- the batch clip path: `infer(data)` -> the post-processed output dict;
- the streaming pair of `serve/streaming.py::make_streaming_fns`:
  `encode_frame(frame)` and `detect_window(features, egodeep, offsets)`.

Where the port differs from the JAX package: the weights travel inside the
artifact as its state, not as an argument. A checkpoint of the same shapes
loads into the loaded module with `load_state_dict`: the batch program's
keys are the model's, the streaming pair's those of the model's
`_model.separate_encoder` and `_model.detector` without that prefix. And
one artifact holds one device's program: `load_serving(..., device=)` moves
it to another (the counterpart of JAX's `platforms=("tpu", "cpu")`).
"""
from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import torch

from future_od_tpu_torch.utils.device import DeviceLike, resolve_device


def export_serving(module: torch.nn.Module, example_args: Tuple,
                   path: Optional[str] = None) -> bytes:
    """`torch.export` of `module(*example_args)`, serialized. The example
    arguments give the shapes and dtypes the program takes (values are not
    traced into it). If `path` is given the blob is also written there."""
    with torch.no_grad():
        exported = torch.export.export(module, tuple(example_args))
    exported.example_inputs = None  # shapes only: the artifact carries no inputs
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_serving(path_or_blob, device: DeviceLike = None) -> torch.nn.Module:
    """An exported serving program, from a path or the raw bytes, as a
    callable module on `device` (default CUDA; raises without a card),
    moved there when it was exported on another device. It enforces the
    exported shapes and dtypes. Call it under `torch.inference_mode()`."""
    from torch.export.passes import move_to_device_pass

    from future_od_tpu_torch.ops import (  # noqa: F401
        flash_attention, fused_resnet, int8_conv, int8_quantize)

    device = resolve_device(device)
    source = path_or_blob if isinstance(path_or_blob, (str, os.PathLike)) else io.BytesIO(
        path_or_blob)
    # not as inference tensors: weights loaded under inference mode gave
    # outputs 1 ulp off the eager forward's on the CPU
    with torch.inference_mode(False):
        exported = torch.export.load(source)
        state = next(iter(exported.state_dict.values()))
        if state.device.type != device.type or (device.index is not None
                                                and state.device.index != device.index):
            exported = move_to_device_pass(exported, device)
        return exported.module()


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def export_inference(model, example_data, path: Optional[str] = None) -> bytes:
    """Export the batch clip path at `example_data`'s shapes (numpy arrays
    or tensors; moved to the model's device). A static-int8 model must be
    calibrated first (ValueError)."""
    from future_od_tpu_torch.ops.quant import assert_calibrated
    from future_od_tpu_torch.train.step import InferenceProgram, to_device_batch

    assert_calibrated(model)

    data = to_device_batch(example_data, _model_device(model))
    return export_serving(InferenceProgram(model).eval(), (data,), path)


def export_streaming(model, example_frame, clip_frames: int = 3,
                     encode_path: Optional[str] = None,
                     detect_path: Optional[str] = None) -> Tuple[bytes, bytes]:
    """Export the streaming pair at one frame batch's shapes; returns
    (encode_blob, detect_blob). The detect program takes the (B, L-1, h, w,
    D) window the encode program fills (and the (B, L-1) offsets in the
    features' dtype, as `StreamingSession.step` passes them), so the
    artifacts pin the server's cache layout."""
    from future_od_tpu_torch.serve.streaming import make_streaming_fns
    from future_od_tpu_torch.train.step import to_device_batch

    frame = to_device_batch(example_frame, _model_device(model.eval()))
    encode_frame, detect_window = make_streaming_fns(
        model, clip_frames=clip_frames, image_hw=tuple(frame["video"].shape[1:3]))
    with torch.inference_mode():  # the window's shapes, as jax.eval_shape gives them
        feats, ego = encode_frame(frame)
    encode_blob = export_serving(encode_frame, (frame,), encode_path)
    W = clip_frames - 1
    window = feats.new_zeros((feats.shape[0], W) + feats.shape[1:])
    ego_window = None if ego is None else ego.new_zeros((ego.shape[0], W) + ego.shape[1:])
    offsets = feats.new_zeros((feats.shape[0], W))
    detect_blob = export_serving(detect_window, (window, ego_window, offsets), detect_path)
    return encode_blob, detect_blob
