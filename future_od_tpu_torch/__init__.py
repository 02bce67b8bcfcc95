"""PyTorch/CUDA port of future_od_tpu for one NVIDIA H100.

The JAX package `future_od_tpu` is the reference; this package mirrors its
layout (`ops/`, `models/`, `train/`, `data/`, `utils/`, and the kernel-study
`tools/`) so each counterpart is easy to find. It imports torch, numpy and the
standard library only — never jax, flax, optax or anything under
`future_od_tpu`.

Public functions keep the JAX layouts, so one batch dict drives both
packages: NHWC video `(B, L, H, W, 3)`, the IMU keys of
`models/st_detr.py::IMU_KEYS`, and `(B, H, N, d)` at the attention kernel.

The Pallas TPU kernels it has ported are hand-written CUDA C++ for Hopper
(`csrc/`), built with nvcc at first use (`ops/_kernels.py`). Each
kernel's wrapper runs its plain PyTorch version on CPU tensors, so the CPU
tests exercise the same wiring; on a CUDA tensor it launches the kernel or
raises.
"""
