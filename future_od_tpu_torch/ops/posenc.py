"""Sine positional encodings (port of future_od_tpu/ops/posenc.py).

Spatial, temporal and query reference-point encodings, computed from index
grids and laid out channels-last, in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

TWO_PI = 2.0 * math.pi


def _sine_encode(embedding: torch.Tensor, num_features: int, temperature: float) -> torch.Tensor:
    """Interleaved sin/cos encoding (...,) -> (..., num_features): even slots
    sin, odd slots cos of the same frequency T^(2*(i//2)/F)."""
    dim_t = torch.arange(num_features, dtype=torch.float32, device=embedding.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_features)
    pos = embedding[..., None] / dim_t
    sin = torch.sin(pos[..., 0::2])
    cos = torch.cos(pos[..., 1::2])
    return torch.stack([sin, cos], dim=-1).reshape(*pos.shape[:-1], -1)


def spatial_encoding(
    h: int, w: int, channels: int, temperature: float = 10000.0, device=None
) -> torch.Tensor:
    """2D sine encoding -> (h, w, channels), y-half then x-half; row i has
    coordinate (i+1)/(h + 1e-6) * 2π."""
    assert channels % 2 == 0
    y = (torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + 1e-6)) * TWO_PI
    x = (torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + 1e-6)) * TWO_PI
    y_enc = _sine_encode(y, channels // 2, temperature)  # (h, C/2)
    x_enc = _sine_encode(x, channels // 2, temperature)  # (w, C/2)
    y_enc = y_enc[:, None, :].expand(h, w, channels // 2)
    x_enc = x_enc[None, :, :].expand(h, w, channels // 2)
    return torch.cat([y_enc, x_enc], dim=-1)


def temporal_encoding(
    num_frames: int,
    channels: int,
    temporal_offsets: Optional[torch.Tensor] = None,
    temperature: float = 10000.0,
    extra_temporal_offset: float = 0.0,
    device=None,
) -> torch.Tensor:
    """Temporal sine term: (B, L, channels) from offsets in seconds (B, L),
    normalized by the last offset, else (L, channels) from frame indices."""
    if temporal_offsets is not None:
        t = temporal_offsets.float() + extra_temporal_offset
        t = t / (t[:, -1:] + 1e-6) * TWO_PI
    else:
        t = (
            torch.arange(1, num_frames + 1, dtype=torch.float32, device=device)
            / (num_frames + 1e-6)
        ) * TWO_PI
    return _sine_encode(t, channels, temperature)


def spatio_temporal_encoding(
    num_frames: int,
    h: int,
    w: int,
    channels: int,
    temporal_offsets: Optional[torch.Tensor] = None,
    no_temporal: bool = False,
    temperature: float = 10000.0,
    extra_temporal_offset: float = 0.0,
    device=None,
) -> torch.Tensor:
    """Spatial (+ optional temporal) encoding of a clip: (L, h, w, C) when
    shared across the batch, else (B, L, h, w, C)."""
    if temporal_offsets is not None:
        device = temporal_offsets.device
    spatial = spatial_encoding(h, w, channels, temperature, device=device)
    spatial = spatial[None].expand(num_frames, h, w, channels)
    if no_temporal:
        return spatial
    temporal = temporal_encoding(
        num_frames, channels, temporal_offsets, temperature, extra_temporal_offset,
        device=device,
    )
    if temporal_offsets is not None:
        return spatial[None] + temporal[:, :, None, None, :]
    return spatial + temporal[:, None, None, :]


def gen_sineembed_for_position(pos: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sine embedding of 2D reference points (..., 2) as (x, y) in [0, 1]
    -> (..., dim) = concat(embed_y, embed_x), each dim/2 wide."""
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / half)

    def interleave(v):
        p = (v * TWO_PI)[..., None] / dim_t
        return torch.stack(
            [torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1
        ).reshape(*p.shape[:-1], -1)

    return torch.cat([interleave(pos[..., 1]), interleave(pos[..., 0])], dim=-1)
