"""The JAX package's mixed precision: bf16 parameters under jnp's type
promotion (future_od_tpu/train/step.py `_to_half`, `_cast_data`).

The JAX step casts every f32 parameter and frozen statistic to bf16 inside
the differentiated function and leaves the rest of the batch as it is. jnp
promotes mixed operands: `x @ kernel` with an f32 `x` and a bf16 kernel is
an f32 product of the bf16-rounded kernel. So the backbone runs in bf16, and
the transformer, whose queries and keys carry the f32 positional encodings
and the f32 IMU embedding, runs mostly in f32 over bf16-rounded weights.

torch promotes elementwise operands the same way, but `F.linear`,
`F.conv2d`, `F.layer_norm` and `torch.einsum` refuse mixed dtypes. Inside
`jax_promotion()` they promote as jnp does, and the model skips its own
casts to the activations' dtype (`cast_like`), which serve the port's
all-bf16 inference.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# the model's products, convolutions and norms (nn.Linear, nn.Conv2d and
# nn.LayerNorm call these)
_PROMOTING = (F.linear, F.conv2d, F.layer_norm, torch.einsum)
_active = [0]


def _floats(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _floats(a)
        elif isinstance(a, torch.Tensor) and a.is_floating_point():
            yield a


def _cast(args, dtype):
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            a = type(a)(_cast(a, dtype))
        elif isinstance(a, torch.Tensor) and a.is_floating_point() and a.dtype != dtype:
            a = a.to(dtype)
        out.append(a)
    return out


class _Promotion(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTING:
            dtypes = {t.dtype for t in _floats((*args, *kwargs.values()))}
            if len(dtypes) > 1:
                dtype = functools.reduce(torch.promote_types, dtypes)
                args = _cast(args, dtype)
                kwargs = dict(zip(kwargs, _cast(kwargs.values(), dtype)))
        return func(*args, **kwargs)


@contextlib.contextmanager
def jax_promotion():
    """Mixed float operands of the products, convolutions and LayerNorm
    promote as jnp's do, and `cast_like` leaves its input as it is."""
    _active[0] += 1
    try:
        with _Promotion():
            yield
    finally:
        _active[0] -= 1


def cast_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """x in ref's dtype (the port's all-bf16 inference), or x as it is under
    `jax_promotion` (the JAX package's mixed precision)."""
    return x if _active[0] else x.to(ref.dtype)


def half_state(model: torch.nn.Module,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every f32 parameter and buffer of `model` cast to `dtype` (`_to_half`):
    differentiable casts, so gradients land in f32 on the masters."""
    return {name: t.to(dtype) if t.dtype == torch.float32 else t
            for name, t in (*model.named_parameters(), *model.named_buffers())}
