"""Generic building blocks (port of future_od_tpu/models/shared_modules.py):
stateful sequencing, batch-first attention with a decoupled head width, the
GEGLU feed-forward and residual wrappers. No model of the repo uses them.

Linear layers take the JAX package's TorchLinear init
(`models/layers.py::init_linear_`); names follow the JAX modules (`to_q`,
`to_kv`, `to_out`; `proj`, `out`).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from future_od_tpu_torch.models.layers import init_linear_


def _linear(in_dim: int, out_dim: int, bias: bool = True,
            generator: Optional[torch.Generator] = None) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    init_linear_(layer.weight, layer.bias, generator)
    return layer


class SequentialWithState(nn.Module):
    """Chain of layers threading optional per-layer state; a layer with
    `stateful = True` takes (x, state) and returns (x, new state)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, state: Optional[List[Any]] = None):
        state = [None] * len(self.layers) if state is None else list(state)
        for idx, layer in enumerate(self.layers):
            if getattr(layer, "stateful", False):
                x, state[idx] = layer(x, state[idx])
            else:
                x = layer(x)
        return x, state


class NoneModule(nn.Module):
    def forward(self, *args, **kwargs):
        return None


class ValueFromDict(nn.Module):
    def __init__(self, key: str):
        super().__init__()
        self.key = key

    def forward(self, x):
        return x[self.key]


class Attention(nn.Module):
    """Batch-first multi-head attention with a decoupled head width: q from
    left (B, M, dim), packed k/v from right (B, N, context_dim), logits
    scaled by head_dim^-0.5, an optional boolean mask (B, M, N) of the
    pairs that may attend."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.to_q = _linear(dim, inner, bias=False, generator=generator)
        self.to_kv = _linear(context_dim or dim, 2 * inner, bias=False, generator=generator)
        self.to_out = _linear(inner, dim, generator=generator)

    def forward(self, left, right=None, mask=None):
        right = left if right is None else right
        B, M, _ = left.shape
        N = right.shape[1]
        H, d = self.num_heads, self.head_dim
        q = self.to_q(left).reshape(B, M, H, d)
        k, v = (t.reshape(B, N, H, d) for t in self.to_kv(right).chunk(2, dim=-1))
        logits = torch.einsum("bmhd,bnhd->bhmn", q, k) * (d ** -0.5)
        if mask is not None:
            logits = torch.where(mask[:, None], logits, torch.full_like(logits, -1e30))
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhmn,bnhd->bmhd", weights, v).reshape(B, M, H * d)
        return self.to_out(out)


class GEGLU(nn.Module):
    """Gated-GELU feed-forward: proj to 2·hidden, a·gelu(gate), back to dim
    (jax.nn.gelu's default, the tanh approximation)."""

    def __init__(self, dim: int, hidden_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = _linear(dim, 2 * hidden_dim, generator=generator)
        self.out = _linear(hidden_dim, dim, generator=generator)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.gelu(gate, approximate="tanh"))


class Residual(nn.Module):
    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x, *args, **kwargs):
        return x + self.inner(x, *args, **kwargs)
