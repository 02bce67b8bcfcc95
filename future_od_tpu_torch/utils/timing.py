"""Device time per call on the card, for the port's kernel-study tools."""
from __future__ import annotations

from typing import Callable

import torch


def device_ms_chained(fn: Callable[..., torch.Tensor], x: torch.Tensor, *rest,
                      iters: int = 10, warmup: int = 3) -> float:
    """Mean device milliseconds of one call of fn(x + c, *rest), by CUDA
    events around `iters` calls after `warmup` calls. Each call's input
    depends on the previous call's output (c = out.flatten()[0] * 1e-30 in
    x's dtype), as the JAX tools' timeit_chained chains them, so every call
    sees fresh data; the time includes that one elementwise add over x. x
    must lie on a CUDA device: there is no host-clock fallback."""
    if x.device.type != "cuda":
        raise ValueError(f"device_ms_chained times CUDA tensors only, got {x.device}")
    c = torch.zeros((), dtype=x.dtype, device=x.device)

    def step(c):
        return (fn(x + c, *rest).flatten()[0] * 1e-30).to(x.dtype)

    for _ in range(warmup):
        c = step(c)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        c = step(c)
    end.record()
    torch.cuda.synchronize(x.device)
    return start.elapsed_time(end) / iters
