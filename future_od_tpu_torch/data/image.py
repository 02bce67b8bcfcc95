"""JPEG decoding, bilinear resizing and normalization on the host, without
OpenCV or PIL (in place of the JAX package's cv2.imread and cv2.resize,
future_od_tpu/data/nu_images.py:79-83 `read_image_rgb` and
future_od_tpu/data/transforms.py `JointResize`).

The work runs in `csrc/jpeg_decode.cpp` (plain C++, built with g++ at first
use by `ops/_kernels.py::host_library`, on any machine). Its decoder follows
libjpeg-turbo's arithmetic, so `read_image_rgb` equals cv2.imread + BGR->RGB
pixel for pixel on baseline files; its resize is cv2's INTER_LINEAR (uint8:
the same 11-bit fixed point; float32: within a float ulp or two). ctypes
releases the interpreter lock around each call, so a thread pool decodes in
parallel.
"""
from __future__ import annotations

import ctypes
import os
from typing import Tuple, Union

import numpy as np

from future_od_tpu_torch.ops._kernels import host_library

_ERRORS = {
    1: "not a JPEG file, or a corrupt one",
    2: "a progressive JPEG, which the decoder does not read (baseline only)",
    3: "an arithmetic-coded JPEG, which the decoder does not read (Huffman only)",
    4: "a 4-component (CMYK or YCCK) JPEG, which the decoder does not read",
    5: "a JPEG sampling layout other than 4:4:4, 4:2:2 and 4:2:0",
    6: "a lossless or 12-bit JPEG, which the decoder does not read (8-bit only)",
}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_jpeg(data: Union[bytes, np.ndarray], name: str = "<bytes>") -> np.ndarray:
    """A baseline JPEG's pixels as (H, W, 3) uint8 RGB (a grayscale file
    gives three equal channels). Raises ValueError naming `name` on a file
    it cannot read."""
    lib = host_library("jpeg_decode")
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = lib.fod_jpeg_header(_ptr(buf), buf.size, ctypes.byref(h), ctypes.byref(w),
                               ctypes.byref(c))
    if code == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        code = lib.fod_jpeg_decode(_ptr(buf), buf.size, _ptr(out), h.value, w.value)
    if code != 0:
        raise ValueError(f"{name}: {_ERRORS.get(code, f'decoder error {code}')}")
    return out


def read_image_rgb(path: str) -> np.ndarray:
    """The JPEG file at `path` as (H, W, 3) uint8 RGB."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return decode_jpeg(np.fromfile(path, np.uint8), path)


def resize_linear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(image, (W, H), interpolation=INTER_LINEAR) of an (h, w, C)
    uint8 or float32 image to `size` = (H, W)."""
    lib = host_library("jpeg_decode")
    if image.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_linear takes uint8 or float32, not {image.dtype}")
    src = np.ascontiguousarray(image)
    if src.ndim == 2:
        src = src[..., None]
    H, W = size
    out = np.empty((H, W, src.shape[2]), src.dtype)
    fn = lib.fod_resize_linear_u8 if src.dtype == np.uint8 else lib.fod_resize_linear_f32
    fn(_ptr(src), src.shape[0], src.shape[1], src.shape[2], _ptr(out), H, W)
    return out.reshape((H, W) + image.shape[2:])


def normalize(images: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 (..., C) images -> float32 (x / 255 - mean) / std, equal to
    numpy's float32 arithmetic bit for bit, in one pass."""
    lib = host_library("jpeg_decode")
    src = np.ascontiguousarray(images, np.uint8)
    mean, std = (np.ascontiguousarray(a, np.float32) for a in (mean, std))
    out = np.empty(src.shape, np.float32)
    cn = src.shape[-1]
    lib.fod_normalize_u8(_ptr(src), src.size // cn, cn, _ptr(mean), _ptr(std), _ptr(out))
    return out
