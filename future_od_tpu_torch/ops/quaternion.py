"""Unit-quaternion helpers for the datasets' ego poses (port of
future_od_tpu/ops/quaternion.py, numpy only). Quaternions are (w, x, y, z)
with the scalar part first."""
from __future__ import annotations

import numpy as np


def concat_quaternion(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Compose two rotations: first q1, then q2. Shapes (*, 4) -> (*, 4)."""
    a1, v1 = q1[..., 0:1], q1[..., 1:4]
    a2, v2 = q2[..., 0:1], q2[..., 1:4]
    scalar = a1 * a2 - np.sum(v1 * v2, axis=-1, keepdims=True)
    vector = a1 * v2 + a2 * v1 + np.cross(v1, v2)
    return np.concatenate([scalar, vector], axis=-1)


def inverse_quaternion(q: np.ndarray) -> np.ndarray:
    """Inverse (= conjugate) of a unit quaternion, shape (*, 4)."""
    return np.concatenate([q[..., 0:1], -q[..., 1:4]], axis=-1)


def relative_pose(translation: np.ndarray, rotation: np.ndarray):
    """A clip's ego poses relative to its first frame: translation (L, 3),
    rotation (L, 4) -> (translation - translation[0], rotation ∘
    rotation[0]^-1)."""
    translation = translation - translation[0:1]
    inv0 = inverse_quaternion(rotation[0:1])
    rotation = concat_quaternion(rotation, np.broadcast_to(inv0, rotation.shape))
    return translation, rotation
